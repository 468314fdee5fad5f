"""Server aggregation policies.  Port of ``repro/fed/policies.py``: the
paper's sync barrier FedAvg; FedAsync and FedBuff wait for ROADMAP Queue A
item 6.

The engine calls ``on_update`` for every arriving update and
``on_round_end`` once per round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

from repro_torch.core.fedavg import fedavg
from repro_torch.kernels.fedavg.ops import fedavg_trees


@dataclass
class ClientUpdate:
    client_id: str
    params: Any                 # decoded (post-codec) discriminator tree
    weight: float               # FedAvg weight (client example count)
    staleness: int = 0          # global versions advanced since download
    recv_time: float = 0.0      # virtual arrival time at the server


class SyncFedAvg:
    """Barrier aggregation — the sequential trainer's exact rule.

    Updates are buffered in arrival order (== participation order under the
    sync engine), and the round-end average calls the same host ``fedavg``
    with the same ordering and weights as the sequential loop, so the
    no-dropout sync path is bit-for-bit identical.  ``use_kernel`` sends
    the aggregation through the fedavg CUDA kernel instead
    (``kernels/fedavg``).
    """
    name = "sync"

    def __init__(self, weighted: bool = True, use_kernel: bool = False):
        self.weighted = weighted
        self.use_kernel = use_kernel
        self._buffer: List[ClientUpdate] = []

    def on_update(self, global_tree, up: ClientUpdate) -> Tuple[Any, bool]:
        self._buffer.append(up)
        return global_tree, False

    def on_round_end(self, global_tree) -> Any:
        if not self._buffer:
            return global_tree
        trees = [u.params for u in self._buffer]
        weights = ([u.weight for u in self._buffer] if self.weighted
                   else None)
        self._buffer = []
        if self.use_kernel:
            return fedavg_trees(trees, weights)
        return fedavg(trees, weights)


def make_policy(fed_cfg, *, weighted: bool = True) -> SyncFedAvg:
    """Factory keyed by ``config.FedConfig.mode``."""
    if fed_cfg.mode == "sync":
        return SyncFedAvg(weighted, fed_cfg.kernel_aggregation)
    if fed_cfg.mode in ("fedasync", "fedbuff"):
        raise NotImplementedError(
            f"fed.mode={fed_cfg.mode!r} is not ported to repro_torch yet "
            f"(ROADMAP Queue A item 6: async engine)")
    raise ValueError(f"unknown fed mode {fed_cfg.mode!r}")
