"""AdamW over a whole parameter tree as hand-written CUDA kernels
(``repro_torch/csrc/adamw.cu``).  Replaces no TPU kernel: the JAX
optimizer is plain JAX, which XLA fuses; the port's eager form
(``ref.py`` a leaf, after the optimizer's global-norm clip) made a dozen
passes over every leaf.

:func:`adamw_leaves_kernel` takes the leaves of one update, of one tree
or of C clients' stacked trees (a row a client): under a clip the norm
pass (``adamw_sumsq_leaves``, one launch a table, then
``adamw_clip_scale``: the scales stay on the device), then one update
launch a table, each element read once and written once.  The tables are
built on the host by :func:`build_tables`, a pure function of addresses,
sizes, dtypes and rows.  The library is built by ``nvcc`` at first use
and called through ``ctypes``.
"""
from __future__ import annotations

import array
import ctypes
import functools
import operator
from itertools import accumulate
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build

BLOCK_ELEMS = 1024      # kBlockElems in adamw.cu: a chunk's elements
MAX_LEAVES = 48         # kLeaves: entries a launch
NORM_BLOCKS = 1024      # kNormBlocks: partial sums a row a norm launch
MAX_ROWS = 65535        # kMaxRows: rows a call

# kind bits of adamw.cu: which of an entry's g, m, v, p are bf16 (the rest
# fp32); p' m' v' take p's, m's and v's
KIND_BITS = (1, 2, 4, 8)
DTYPES = (torch.float32, torch.bfloat16)

_T = torch.Tensor
_dtype = operator.attrgetter("dtype")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("adamw")
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.adamw_update_leaves.argtypes = ([p, i32, i32, p, p, p, p]
                                        + [f32] * 7 + [p])
    lib.adamw_sumsq_leaves.argtypes = [p, i32, i32, p, p]
    lib.adamw_clip_scale.argtypes = [p, i32, i32, f32, p, p]
    for fn in (lib.adamw_update_leaves, lib.adamw_sumsq_leaves,
               lib.adamw_clip_scale):
        fn.restype = ctypes.c_int
    return lib


def build_tables(ptrs: Sequence[Sequence[int]], sizes: Sequence[int],
                 kinds: Sequence[int], rows: Optional[Sequence[int]] = None
                 ) -> Tuple[array.array, List[Tuple[int, int]]]:
    """The launches of one update, as ``adamw_update_leaves`` and
    ``adamw_sumsq_leaves`` take them.

    ``ptrs[l]``: entry ``l``'s seven addresses ``(g, m, v, p, p', m',
    v')``; ``sizes[l]``: its element count; ``kinds[l]``: its bf16 bits (1
    g, 2 m, 4 v, 8 p); ``rows[l]``: its row (default 0), never decreasing.
    Returns one ``array('q')`` holding every launch's table, and
    ``(offset, n)`` a launch in order: its table starts at word ``offset``
    and covers ``n`` entries.  Entries go in order, ``MAX_LEAVES`` a
    table; entries of no elements take no place.  A table is ``[g: n] [m:
    n] [v: n] [p: n] [p': n] [m': n] [v': n] [N: n] [first: n + 1] [kind:
    n] [row: n] [vec]``: ``first`` the entries' first chunks of
    ``BLOCK_ELEMS`` elements, ``vec`` the mask of entries whose N is a
    multiple of 4 and whose seven addresses are each aligned to 4
    elements of its dtype."""
    rows = [0] * len(sizes) if rows is None else list(rows)
    if any(b < a for a, b in zip(rows, rows[1:])):
        raise ValueError(f"build_tables: rows decrease: {rows}")
    live = [l for l, n in enumerate(sizes) if n > 0]
    words: List[int] = []
    launches = []
    for i in range(0, len(live), MAX_LEAVES):
        group = live[i:i + MAX_LEAVES]
        vec = 0
        for j, l in enumerate(group):
            g, m, v, p = (2 if kinds[l] & b else 4 for b in KIND_BITS)
            widths = (4 * g, 4 * m, 4 * v, 4 * p, 4 * p, 4 * m, 4 * v)
            if sizes[l] % 4 == 0 and not any(
                    a % w for a, w in zip(ptrs[l], widths)):
                vec |= 1 << j
        launches.append((len(words), len(group)))
        for k in range(7):
            words += [ptrs[l][k] for l in group]
        ns = [sizes[l] for l in group]
        words += ns
        words += accumulate([-(-n // BLOCK_ELEMS) for n in ns], initial=0)
        words += [kinds[l] for l in group]
        words += [rows[l] for l in group]
        words.append(vec)
    return array.array("q", words), launches


def _kind(g: _T, m: _T, v: _T, p: _T) -> int:
    return sum(b for b, t in zip(KIND_BITS, (g, m, v, p))
               if t.dtype == torch.bfloat16)


def _check(name: str, groups: Sequence[Sequence[_T]]) -> torch.device:
    """Every tensor on one CUDA device, fp32 or bf16, contiguous, each
    leaf's tensors of one size.  A few calls into torch for the whole
    tree: a Python loop over its tensors costs more than the launch."""
    everything = [t for grp in groups for t in grp]
    dev = everything[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if set(map(_T.get_device, everything)) != {dev.index}:
        raise ValueError(f"{name}: every tensor must be on {dev}")
    if not set(map(_dtype, everything)) <= set(DTYPES):
        raise TypeError(f"{name} takes float32 and bfloat16 tensors, got "
                        f"{sorted(set(map(str, map(_dtype, everything))))}")
    if not all(map(_T.is_contiguous, everything)):
        raise ValueError(f"{name}: every tensor must be contiguous")
    sizes = [list(map(_T.numel, grp)) for grp in groups]
    if any(s != sizes[0] for s in sizes):
        raise ValueError(f"{name}: leaf sizes differ between g, m, v and p: "
                         f"{sizes}")
    return dev


def _check_words(name: str, k: str, b: _T, rows: int,
                 dev: torch.device) -> None:
    if (b.device != dev or b.dtype != torch.float32 or b.numel() != rows
            or not b.is_contiguous()):
        raise ValueError(f"{name}: {k} must be {rows} contiguous float32 "
                         f"elements on {dev}, got {b.dtype} "
                         f"{tuple(b.shape)} on {b.device}")


def _launched(err: int, what: str) -> None:
    """Raises for a launch the library refused; counts the rest."""
    if err != 0:
        raise RuntimeError(f"adamw {what} launch failed: CUDA error {err}")
    adamw_leaves_kernel.launches += 1


def _clip_scale(table: array.array, launches, rows: int, max_norm: float,
                dev: torch.device, stream: int) -> _T:
    """The norm pass of every table and the fold of their partial sums
    into the clip scale of each row, ``rows`` fp32 words on ``dev``."""
    lib = _lib()
    per_launch = NORM_BLOCKS * rows
    partials = torch.empty((per_launch * len(launches),),
                           dtype=torch.float64, device=dev)
    scale = torch.empty((rows,), dtype=torch.float32, device=dev)
    base = table.buffer_info()[0]
    for k, (offset, n) in enumerate(launches):
        _launched(lib.adamw_sumsq_leaves(
            base + 8 * offset, n, rows,
            partials.data_ptr() + 8 * per_launch * k, stream), "norm")
    _launched(lib.adamw_clip_scale(partials.data_ptr(), len(launches), rows,
                                   max_norm, scale.data_ptr(), stream),
              "clip scale")
    return scale


def clip_scale_kernel(grads: Sequence[_T], max_norm: float) -> _T:
    """``min(max_norm / max(||grads||, 1e-9), 1)`` as a 0-dim fp32 tensor
    on the grads' CUDA device (fp32 or bf16, contiguous): the norm pass
    alone.  The partial sums are added in a fixed order, so two calls give
    the same bits; on the current stream, does not synchronise."""
    name = "clip_scale_kernel"
    grads = list(grads)
    if not grads:
        raise ValueError(f"{name}: no leaves")
    dev = _check(name, [grads])
    sizes = list(map(_T.numel, grads))
    ptrs = [(a,) * 7 for a in map(_T.data_ptr, grads)]
    kinds = [1 if d == torch.bfloat16 else 0 for d in map(_dtype, grads)]
    table, launches = build_tables(ptrs, sizes, kinds)
    if not launches:
        raise ValueError(f"{name}: every leaf is empty")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _clip_scale(table, launches, 1, float(max_norm), dev,
                           stream).reshape(())


def adamw_leaves_kernel(grads: Sequence[_T], ms: Sequence[_T],
                        vs: Sequence[_T], ps: Sequence[_T], bc1: _T, bc2: _T,
                        lr: Union[float, _T], *, beta1: float, beta2: float,
                        eps: float, weight_decay: float, grad_clip: float
                        ) -> Tuple[List[_T], List[_T], List[_T]]:
    """One AdamW step over a tree's leaves, or over C clients' at once, on
    a CUDA device: ``grads``, ``ms``, ``vs``, ``ps`` (leaf ``l`` of each:
    one size, any shape, fp32 or bf16, contiguous); ``bc1``, ``bc2``:
    ``1 - beta^t`` as R contiguous fp32 device words.  Each leaf is R
    equal rows in memory order (R = 1: one tree; R = C: stacked trees
    ``(C, ...)``, a client a row), and row ``r`` of every leaf is updated
    with ``bc1[r]``, ``bc2[r]`` and its ``lr``, under ``grad_clip`` > 0
    after a clip by the global norm of the rows ``r`` of every leaf: each
    client as its own update would update it.  ``lr``: a number or a
    one-element CPU tensor (as the schedules give it), read on the host,
    every row's; or R fp32 device words, read by the kernel.  ->
    ``(ps', ms', vs')``, fresh tensors of the inputs' shapes and dtypes;
    the inputs are not written.

    Under a clip the norm pass first (its scales kept on the device), then
    one update launch a table of ``MAX_LEAVES`` entries, an entry a row of
    a leaf.  On the current stream; does not synchronise.  Raises on any
    input the kernels do not take and when a launch is refused."""
    name = "adamw_leaves_kernel"
    groups = [list(grads), list(ms), list(vs), list(ps)]
    n = len(groups[3])
    if n == 0 or any(len(grp) != n for grp in groups):
        raise ValueError(f"{name}: leaves of g, m, v, p "
                         f"{[len(grp) for grp in groups]}: need one list of "
                         f"n >= 1 each")
    dev = _check(name, groups)
    rows = bc1.numel()
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"{name}: {rows} rows, need 1 to {MAX_ROWS}")
    _check_words(name, "bc1", bc1, rows, dev)
    _check_words(name, "bc2", bc2, rows, dev)
    if isinstance(lr, torch.Tensor) and lr.device.type != "cpu":
        _check_words(name, "lr", lr, rows, dev)
        lr_row, lr = lr.data_ptr(), 0.0
    else:
        lr_row, lr = None, float(lr)   # a number or a CPU tensor: no sync
    gs, ms, vs, ps = groups
    sizes = list(map(_T.numel, ps))
    if any(s % rows for s in sizes):
        raise ValueError(f"{name}: leaf sizes {sizes} do not split into "
                         f"{rows} rows")
    new_p = list(map(torch.empty_like, ps))
    new_m = list(map(torch.empty_like, ms))
    new_v = list(map(torch.empty_like, vs))
    # an entry a row of a leaf, row-major: every leaf's row 0, then row 1
    ts = (gs, ms, vs, ps, new_p, new_m, new_v)
    addr = list(zip(*(map(_T.data_ptr, grp) for grp in ts)))
    widths = list(zip(*(map(_T.element_size, grp) for grp in ts)))
    per_row = [s // rows for s in sizes]
    table, launches = build_tables(
        [tuple(a + r * k * w for a, w in zip(al, wl))
         for r in range(rows) for al, wl, k in zip(addr, widths, per_row)],
        per_row * rows, list(map(_kind, gs, ms, vs, ps)) * rows,
        [r for r in range(rows) for _ in range(n)])
    if launches:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            scale = (_clip_scale(table, launches, rows, float(grad_clip),
                                 dev, stream) if grad_clip else None)
            fn, base = _lib().adamw_update_leaves, table.buffer_info()[0]
            for offset, k in launches:
                _launched(fn(base + 8 * offset, k, rows, bc1.data_ptr(),
                             bc2.data_ptr(), lr_row,
                             None if scale is None else scale.data_ptr(),
                             lr, beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
                             weight_decay, stream), "update")
    adamw_leaves_kernel.kernel_leaves += n * rows
    return new_p, new_m, new_v


# kernel launches in this process (norm, scale and update passes), and the
# leaves updated through the kernels and through the plain form, a
# client's leaf of a stacked update counted as one (a run reads them to
# show how often its optimizer went through the kernels)
adamw_leaves_kernel.launches = 0
adamw_leaves_kernel.kernel_leaves = 0
adamw_leaves_kernel.plain_leaves = 0
