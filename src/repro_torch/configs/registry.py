"""Architecture registry (port of ``repro/configs/registry.py``):
``--arch <id>`` resolution, optionally bound to an input shape.

Every architecture of the JAX registry: the LM substrate's ten and the
paper's own model.  ``long_500k`` applicability as in the reference:
native for state-based archs, a sliding-window variant for
full-attention decoders, skipped for whisper.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

from repro_torch.config import ATTN_SLIDING, INPUT_SHAPES, RunConfig

# arch id -> module name
_ARCHS: Dict[str, str] = {
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1b6",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "granite-20b": "repro_torch.configs.granite_20b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    # the paper's own model
    "dcgan-mnist": "repro_torch.configs.dcgan_mnist",
}

ASSIGNED_ARCHS: List[str] = [a for a in _ARCHS if a != "dcgan-mnist"]
SHAPES: List[str] = list(INPUT_SHAPES)

# long_500k handling per arch
LONG_NATIVE = {"rwkv6-1.6b", "recurrentgemma-9b"}
LONG_SKIP = {"whisper-base"}          # decoder max positions = 448


class SkippedShape(Exception):
    """Raised when an (arch, shape) pair is skipped by design."""


def list_archs() -> List[str]:
    return list(_ARCHS)


def get_config(arch: str, shape: Optional[str] = None) -> RunConfig:
    """Resolve ``--arch <id>``, optionally bound to one of
    ``INPUT_SHAPES``."""
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    cfg: RunConfig = importlib.import_module(_ARCHS[arch]).config()
    if shape is not None:
        if shape not in INPUT_SHAPES:
            raise KeyError(f"unknown shape {shape!r}; known: {SHAPES}")
        cfg = cfg.override({
            "shape.name": INPUT_SHAPES[shape].name,
            "shape.seq_len": INPUT_SHAPES[shape].seq_len,
            "shape.global_batch": INPUT_SHAPES[shape].global_batch,
            "shape.mode": INPUT_SHAPES[shape].mode,
        })
        if shape == "long_500k" and arch not in LONG_NATIVE:
            if arch in LONG_SKIP:
                raise SkippedShape(
                    f"{arch}: long_500k skipped (decoder max positions 448)")
            # dense/moe/vlm: beyond-paper sliding-window variant
            cfg = cfg.override({"model.attention": ATTN_SLIDING,
                                "model.sliding_window": 4096})
        cfg = cfg.validate()
    return cfg


def iter_pairs(include_skipped: bool = False):
    """Yield (arch, shape, cfg_or_None) for the 10 x 4 matrix of the LM
    archs and input shapes (None for a pair skipped by design, when
    ``include_skipped``)."""
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            try:
                yield arch, shape, get_config(arch, shape)
            except SkippedShape:
                if include_skipped:
                    yield arch, shape, None
