"""Parameter-tree checkpointing to .npz (no external deps).  Port of
``repro/checkpoint/io.py``, in the same file format, so a checkpoint
written by either package loads in the other bit for bit.

The format: one array a leaf, keyed by the leaf's path (dict keys and
list indices joined by ``//``) in ``jax.tree.leaves`` order (dict keys
sorted); bfloat16 leaves stored as their ``uint16`` bits, named in the
``dtypes`` of a ``__meta__`` JSON sidecar beside the caller's ``extra``;
written to ``<path>.tmp`` and then moved over ``path``.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "//"


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves`` order: dict keys sorted,
    lists and tuples by index, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [(_SEP.join(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, prefix + (k,)))
    return out


def _unflatten(like, it):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, it) for v in like)
    if like is None:
        return None
    return next(it)


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """A leaf as numpy, and whether it is bfloat16 (then as its uint16
    bits: numpy has no bfloat16 of its own)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        return arr.view(np.uint16), True
    return arr, False


def save_pytree(path: str, tree, extra: Optional[Dict[str, Any]] = None
                ) -> None:
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for key, leaf in _flatten_with_paths(tree):
        arr, bf16 = _to_numpy(leaf)
        if bf16:
            dtypes[key] = "bfloat16"
        arrays[key] = arr
    meta = {"dtypes": dtypes, "extra": extra or {}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(
            json.dumps(meta).encode(), np.uint8), **arrays)
    os.replace(tmp, path)


def _tensor(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_pytree(path: str, like=None) -> Tuple[Any, Dict[str, Any]]:
    """Load ``(tree, extra)``.

    With ``like``, the tree has ``like``'s structure and each leaf lies on
    ``like``'s leaf device in its dtype (a leaf of ``like`` that is not a
    tensor gives a CPU tensor).  Without it, the tree is the flat dict
    ``{path: tensor}`` of CPU tensors, a bfloat16 leaf as
    ``torch.bfloat16``: where the JAX package returns numpy arrays, the
    port returns tensors, since numpy has no bfloat16 without
    ``ml_dtypes`` and the port does not depend on it."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    bf16 = {k for k, dt in meta["dtypes"].items() if dt == "bfloat16"}
    if like is None:
        return ({k: _tensor(a, k in bf16) for k, a in arrays.items()},
                meta["extra"])
    flat = _flatten_with_paths(like)
    missing = [k for k, _ in flat if k not in arrays]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    leaves = []
    for k, ref in flat:
        t = _tensor(arrays[k], k in bf16)
        if isinstance(ref, torch.Tensor):
            t = t.to(device=ref.device, dtype=ref.dtype)
        leaves.append(t)
    return _unflatten(like, iter(leaves)), meta["extra"]


class CheckpointManager:
    """Step-indexed checkpoints with retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> str:
        p = self._path(step)
        save_pytree(p, tree, {**(extra or {}), "step": step})
        self._gc()
        return p

    def steps(self) -> List[int]:
        pat = re.compile(r"ckpt_(\d+)\.npz$")
        out = []
        for f in os.listdir(self.dir):
            m = pat.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, like=None, step: Optional[int] = None):
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = step if step is not None else steps[-1]
        return load_pytree(self._path(step), like)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            os.remove(self._path(s))
