"""Per-round content digests of the global training state.  Port of
``repro/obs/digest.py``.

A digest makes a bit-exactness claim checkable *across runs from artifacts
alone*: two runs whose ``digests.jsonl`` rows match round for round held
byte-identical global state at every round boundary.  The recorder writes
one :class:`RoundDigest` per round; ``repro_torch.obs.diff`` aligns and
compares them, and localizes the first diverging round.

Two comparison granularities, because the port pins two kinds of equality:

  * **hash** (:func:`tree_digest`) — a blake2b over every leaf's path,
    dtype, shape and raw bytes.  Equal hashes == bit-identical trees: the
    artifact form of the BIT-EXACT pins (obs-on == obs-off, engine loop ==
    sequential, frozen == static).  Hashes of the port's trees cannot
    equal the JAX package's (other dtype names, other framework).
  * **sketch** (:func:`tree_sketch`) — a tiny float summary (L2 norm,
    sum, absmax, leaf count) in float64.  Hashes can't measure *distance*;
    the sketch is what lets loop-vs-vectorized (a TOLERANCE pin) be
    checked across runs, lets ``diff.py`` report the magnitude of a
    numeric divergence, and is how the port's state is compared with the
    JAX package's.

Trees are the port's: nested dicts (walked in sorted-key order, as
``jax.tree`` walks them), tuples and lists of tensors, arrays or numbers.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import asdict, dataclass
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in ``jax.tree_util.tree_flatten_with_path`` order,
    the path written as ``jax.tree_util.keystr`` writes it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from leaves_with_path(x, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _leaf_bytes(leaf: Any) -> Tuple[str, Tuple[int, ...], bytes]:
    """(dtype name, shape, raw bytes) of a tensor, array or number."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return str(t.dtype).replace("torch.", ""), tuple(t.shape), raw
    arr = np.asarray(leaf)
    return str(arr.dtype), tuple(arr.shape), arr.tobytes()


def tree_digest(tree: Any) -> str:
    """Content hash of a tree: blake2b over each leaf's path, dtype,
    shape and raw bytes (dict keys traverse sorted, so the walk order is
    deterministic).  Equal digests <=> bit-identical trees."""
    h = hashlib.blake2b(digest_size=16)
    for path, leaf in leaves_with_path(tree):
        dtype, shape, raw = _leaf_bytes(leaf)
        h.update(path.encode())
        h.update(dtype.encode())
        h.update(str(shape).encode())
        h.update(raw)
    return h.hexdigest()


def tree_sketch(tree: Any) -> Tuple[float, float, float, int]:
    """``(l2, sum, absmax, leaves)`` over the tree's floating leaves, in
    float64 on each leaf's device — the tolerance-comparable companion to
    :func:`tree_digest`."""
    sq, total, mx, n = 0.0, 0.0, 0.0, 0
    for _, leaf in leaves_with_path(tree):
        t = torch.as_tensor(leaf)
        n += 1
        if not (t.is_floating_point() or t.is_complex()):
            continue
        a64 = t.detach().to(torch.float64)
        sq += float(torch.sum(a64 * a64))
        total += float(torch.sum(a64))
        if a64.numel():
            mx = max(mx, float(torch.max(torch.abs(a64))))
    return (math.sqrt(sq), total, mx, n)


@dataclass(frozen=True)
class RoundDigest:
    """One round's committed global state, content-addressed.

    ``global_digest`` hashes the broadcast global discriminator (what every
    replica equals after the round), ``opt_digest`` the per-client
    optimizer states that committed, ``gan_digest`` the server generator
    (params + opt).  ``aggregated_digest`` is the engine's as-aggregated
    global tree BEFORE any health action — under ``policy='rollback'`` a
    poisoned round records the NaN'd aggregate there while the committed
    ``global_digest`` equals the restored (last healthy) state."""
    round_index: int
    global_digest: str
    opt_digest: str = ""
    gan_digest: str = ""
    aggregated_digest: str = ""
    rolled_back: bool = False
    # tolerance-comparable sketch of the committed global discriminator
    global_sketch: Tuple[float, float, float, int] = (0.0, 0.0, 0.0, 0)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def digest_to_dict(d: RoundDigest) -> Dict[str, Any]:
    return asdict(d)


def digest_from_dict(d: Dict[str, Any]) -> RoundDigest:
    d = dict(d)
    d["global_sketch"] = tuple(d.get("global_sketch", (0.0, 0.0, 0.0, 0)))
    return RoundDigest(**d)


def state_digest(d_params: Any, d_opt: Any, g_params: Any, g_opt: Any,
                 *, round_index: int, aggregated: str = "",
                 rolled_back: bool = False) -> RoundDigest:
    """Digest one trainer round's committed state (the single assembly
    point the trainer and the in-memory recompute tests share)."""
    return RoundDigest(
        round_index=round_index,
        global_digest=tree_digest(d_params),
        opt_digest=tree_digest(d_opt),
        gan_digest=tree_digest((g_params, g_opt)),
        aggregated_digest=aggregated,
        rolled_back=rolled_back,
        global_sketch=tree_sketch(d_params))
