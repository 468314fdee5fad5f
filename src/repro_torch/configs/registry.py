"""Architecture registry (port of ``repro/configs/registry.py``).

Only the paper's own model is ported; every other architecture of the JAX
registry waits for the LM substrate (ROADMAP Queue A item 10).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import RunConfig

# arch id -> module name
_ARCHS: Dict[str, str] = {
    "dcgan-mnist": "repro_torch.configs.dcgan_mnist",
}


def list_archs() -> List[str]:
    return list(_ARCHS)


def get_config(arch: str) -> RunConfig:
    """Resolve ``--arch <id>`` among the ported architectures."""
    if arch not in _ARCHS:
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet (ROADMAP Queue "
            f"A item 10); ported: {sorted(_ARCHS)}")
    return importlib.import_module(_ARCHS[arch]).config()
