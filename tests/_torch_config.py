"""The port's configuration as the JAX package's: the config-parity tests
compare ``reference_dict(port_cfg)`` with the JAX config's ``to_dict()``.

The port has settings the JAX package lacks (``PORT_ONLY``); at their
defaults they give the JAX package's behaviour, and ``reference_dict``
leaves them out of the dict.  One that is set away from its default stays
in, so such a config never reads as the reference's.

A test module takes it by importing it by name, as it imports the
``_hyp`` shim.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.config import RunConfig

PORT_ONLY = {
    ("model",): ("first_dense_layers",),
    ("model", "moe"): ("norm_topk_prob", "expert_shards", "expert_shard"),
    ("model", "mla"): ("yarn_factor",),
}


def reference_dict(cfg: RunConfig) -> Dict[str, Any]:
    d, default = cfg.to_dict(), RunConfig().to_dict()
    for path, keys in PORT_ONLY.items():
        sub, dflt = d, default
        for k in path:
            sub, dflt = sub[k], dflt[k]
        for k in keys:
            if sub[k] == dflt[k]:
                del sub[k]
    return d
