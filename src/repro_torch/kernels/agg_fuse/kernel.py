"""Compressed-domain server reduce as hand-written CUDA kernels
(``repro_torch/csrc/agg_fuse.cu``), replacing the Pallas TPU kernels of
``repro/kernels/agg_fuse/kernel.py``: ``dequant_reduce_kernel``,
``dequant_acc_kernel`` and ``scatter_acc_kernel``.  Each launch covers a
table of leaves: ``dequant_reduce_leaves_kernel`` a whole round's reduce,
reading each client's wire in place, ``dequant_acc_leaves_kernel`` and
``scatter_acc_leaves_kernel`` a whole uplink's fold.  The one-leaf
functions of the reference's interface are one-entry tables, and each
kernel's launch count lives on its table function.

Wires are int8, fp16 or fp32 and are read at that width; nothing
dequantised is written.  The accumulating kernels update ``acc`` in place,
as the JAX ops donate it, and return it.  An int8 wire's scale is a 0-dim
device tensor passed by pointer, so no call synchronises with the host.
Built by ``nvcc`` at first use and called through ``ctypes``.
"""
from __future__ import annotations

import array
import ctypes
import functools
import operator
from itertools import chain
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import build

# dtype codes of agg_fuse.cu
WIRE_DTYPES = {torch.float32: 0, torch.float16: 1, torch.int8: 2}
MAX_LEAVES = 64         # kMaxLeaves in agg_fuse.cu: leaves an acc or
                        # scatter launch
REDUCE_CLIENTS = 16     # kReduceClients: clients a reduce launch
REDUCE_LEAVES = 32      # kReduceLeaves: leaves a reduce launch
REDUCE_ENTRIES = 192    # kReduceEntries: (leaf, client) pairs a reduce launch


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("agg_fuse")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    i32 = ctypes.c_int
    lib.agg_dequant_reduce_leaves.argtypes = [p, p, i32, i64, i64, i32, i32,
                                              p, i64, p]
    lib.agg_dequant_acc_leaves.argtypes = [p, i32, i32, ctypes.c_float, p]
    lib.agg_scatter_acc_leaves.argtypes = [p, i32, ctypes.c_float, p]
    for fn in (lib.agg_dequant_reduce_leaves, lib.agg_dequant_acc_leaves,
               lib.agg_scatter_acc_leaves):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, ref: torch.Tensor, **tensors) -> None:
    """Every tensor on ``ref``'s CUDA device and contiguous."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {ref.device}")
    for k, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {k} on {t.device}, not {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")


def _wire_code(name: str, wire: torch.Tensor) -> int:
    if wire.dtype not in WIRE_DTYPES:
        raise TypeError(f"{name}: wire dtype {wire.dtype}, expected one of "
                        f"{list(WIRE_DTYPES)}")
    return WIRE_DTYPES[wire.dtype]


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


_T = torch.Tensor
_dtype = operator.attrgetter("dtype")


def _same(tensors: List[torch.Tensor], gpu: int, dtype: torch.dtype,
          contiguous: bool = True) -> bool:
    """Every tensor of ``dtype`` on CUDA device ``gpu`` (and contiguous).  A
    few calls into torch for the whole list: the table wrappers check every
    tensor of a fold or a round, and a Python loop over them costs more
    than the launch."""
    return (set(map(_T.get_device, tensors)) == {gpu}
            and set(map(_dtype, tensors)) == {dtype}
            and (not contiguous or all(map(_T.is_contiguous, tensors))))


def _first_bad(what: str, groups, gpu: int, dtype: torch.dtype,
               sizes: Sequence[int]) -> ValueError:
    """The error naming the first tensor of ``groups`` (a list a leaf) that
    is not a contiguous ``dtype`` tensor of its leaf's size on the card."""
    for leaf, (ts, n) in enumerate(zip(groups, sizes)):
        for i, t in enumerate(ts):
            if not (t.get_device() == gpu and t.dtype == dtype
                    and t.is_contiguous() and t.numel() == n):
                return ValueError(
                    f"{what} {i} of leaf {leaf}: {tuple(t.shape)} {t.dtype} "
                    f"on {t.device}; need a contiguous {dtype} tensor of {n} "
                    f"elements on cuda:{gpu}")
    return ValueError(f"{what}: no tensor to check")


def _reduce_launches(leaf_desc: array.array, wire_desc: array.array,
                     n_leaves: int, n_clients: int, code: int, w_ptr: int,
                     w_stride: int, dev: torch.device) -> None:
    """Launch a reduce over a table: ``leaf_desc`` holds (out, N) a leaf,
    ``wire_desc`` (wire, scale) a (leaf, client), leaf-major.  Clients go
    in chunks of ``REDUCE_CLIENTS`` in client order (a later chunk adds to
    ``out``), each chunk's leaves in as few launches as the table takes."""
    per = min(REDUCE_LEAVES, REDUCE_ENTRIES // min(n_clients, REDUCE_CLIENTS))
    leaves, wires = leaf_desc.buffer_info()[0], wire_desc.buffer_info()[0]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        for c0 in range(0, n_clients, REDUCE_CLIENTS):
            nc = min(REDUCE_CLIENTS, n_clients - c0)
            for l0 in range(0, n_leaves, per):
                err = lib.agg_dequant_reduce_leaves(
                    leaves + 16 * l0, wires + 16 * l0 * n_clients,
                    min(per, n_leaves - l0), n_clients, c0, nc, code,
                    w_ptr + 4 * c0 * w_stride, w_stride, stream)
                _launched("dequant_reduce", err)
                dequant_reduce_leaves_kernel.launches += 1


def dequant_reduce_leaves_kernel(outs: Sequence[torch.Tensor],
                                 wires_by_leaf: Sequence[Sequence[
                                     torch.Tensor]],
                                 w: torch.Tensor,
                                 scales_by_leaf: Optional[Sequence[Sequence[
                                     torch.Tensor]]] = None
                                 ) -> List[torch.Tensor]:
    """A whole round's dense reduce: ``outs[l]`` (fp32, N_l elements, on a
    CUDA device) is WRITTEN with ``sum_c w[c] * s_lc * wires_by_leaf[l][c]``,
    each client's wire (int8/fp16/fp32, one dtype for all, any contiguous
    shape of N_l elements) read where it lies.  ``w``: the (C,) fp32
    weights, already normalised; ``scales_by_leaf[l][c]``: a one-element
    fp32 device tensor (int8 wires), or ``scales_by_leaf`` None for every
    scale 1.0.  -> ``outs``.

    One launch for the whole table while ``C <= REDUCE_CLIENTS`` and the
    (leaf, client) pairs fit one launch's table; more clients take a launch
    a chunk of ``REDUCE_CLIENTS``, with the same bits.  On the current
    stream; does not synchronise.  Raises on any input the kernel does not
    take and when a launch is refused."""
    name = "dequant_reduce_leaves_kernel"
    n_leaves = len(outs)
    if n_leaves == 0 or len(wires_by_leaf) != n_leaves or (
            scales_by_leaf is not None and len(scales_by_leaf) != n_leaves):
        raise ValueError(f"{n_leaves} outputs, {len(wires_by_leaf)} leaves "
                         f"of wires: need as many, at least one")
    dev = w.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    gpu, n_clients = dev.index, w.numel()
    if (w.dtype != torch.float32 or w.dim() != 1 or n_clients == 0
            or not w.is_contiguous()):
        raise ValueError(f"{name}: w must be a contiguous (C,) float32 "
                         f"tensor, C >= 1; got {tuple(w.shape)} {w.dtype}")
    if any(len(ws) != n_clients for ws in wires_by_leaf) or (
            scales_by_leaf is not None
            and any(len(ss) != n_clients for ss in scales_by_leaf)):
        raise ValueError(f"{name}: need {n_clients} wires (and scales) a "
                         f"leaf, one a weight")
    wires = list(chain.from_iterable(wires_by_leaf))
    dtype = wires[0].dtype
    code = _wire_code(name, wires[0])
    ns = list(map(_T.numel, outs))
    if not (_same(outs, gpu, torch.float32) and min(ns) > 0):
        raise _first_bad("out", [[o] for o in outs], gpu, torch.float32,
                         [max(n, 1) for n in ns])
    if not (_same(wires, gpu, dtype) and list(map(_T.numel, wires))
            == [n for n in ns for _ in range(n_clients)]):
        raise _first_bad("wire", wires_by_leaf, gpu, dtype, ns)
    wire_desc = [0] * (2 * len(wires))
    wire_desc[0::2] = list(map(_T.data_ptr, wires))
    if scales_by_leaf is not None:
        scales = list(chain.from_iterable(scales_by_leaf))
        # one element: contiguous whatever its strides
        if not (_same(scales, gpu, torch.float32, contiguous=False)
                and set(map(_T.numel, scales)) == {1}):
            raise _first_bad("scale", scales_by_leaf, gpu, torch.float32,
                             [1] * n_leaves)
        wire_desc[1::2] = list(map(_T.data_ptr, scales))
    leaf_desc = [0] * (2 * n_leaves)
    leaf_desc[0::2] = list(map(_T.data_ptr, outs))
    leaf_desc[1::2] = ns
    _reduce_launches(array.array("q", leaf_desc), array.array("q", wire_desc),
                     n_leaves, n_clients, code, w.data_ptr(), 1, dev)
    return list(outs)


def dequant_reduce_kernel(wires: torch.Tensor, coefs: torch.Tensor
                          ) -> torch.Tensor:
    """wires: (C, N) int8/fp16/fp32 on a CUDA device; coefs: (C, 2) fp32
    ``[weight, scale]`` a client (weights already normalised) -> (N,) fp32
    ``sum_c w_c * s_c * wires[c]``.

    A one-leaf table over the rows of the stack
    (``dequant_reduce_leaves_kernel``'s launches): on the current stream,
    does not synchronise.  Raises on any input the kernel does not take and
    when the launch is refused."""
    _check("dequant_reduce_kernel", wires, wires=wires, coefs=coefs)
    code = _wire_code("dequant_reduce_kernel", wires)
    if coefs.dtype != torch.float32:
        raise TypeError(f"coefs must be float32, got {coefs.dtype}")
    if wires.dim() != 2 or coefs.shape != (wires.shape[0], 2):
        raise ValueError(f"shapes {tuple(wires.shape)} and "
                         f"{tuple(coefs.shape)}: need (C, N) and (C, 2)")
    c, n = wires.shape
    if c == 0 or n == 0:
        raise ValueError(f"wires {tuple(wires.shape)}: need C, N >= 1")
    out = torch.empty((n,), dtype=torch.float32, device=wires.device)
    row, cp = n * wires.element_size(), coefs.data_ptr()
    wire_desc = array.array("q")
    for k in range(c):
        wire_desc.extend((wires.data_ptr() + k * row, cp + 8 * k + 4))
    _reduce_launches(array.array("q", (out.data_ptr(), n)), wire_desc, 1, c,
                     code, cp, 2, wires.device)
    return out


def dequant_acc_leaves_kernel(accs: Sequence[torch.Tensor],
                              wires: Sequence[torch.Tensor], weight: float,
                              scales: Optional[Sequence[torch.Tensor]] = None
                              ) -> List[torch.Tensor]:
    """A whole dense fold: for each leaf ``l``, ``accs[l]`` (fp32, N_l
    elements, on a CUDA device, UPDATED IN PLACE) takes ``(w * s_l) *
    wires[l]`` (int8/fp16/fp32, one dtype for all, any contiguous shape of
    N_l elements).  ``weight`` a Python number (rounded to fp32);
    ``scales[l]``: a one-element fp32 device tensor (int8 wires), or
    ``scales`` None for every scale 1.0.  -> ``accs``.

    One launch for every ``MAX_LEAVES`` leaves, on the current stream; does
    not synchronise.  Raises on any input the kernel does not take and when
    a launch is refused."""
    name = "dequant_acc_leaves_kernel"
    n_leaves = len(accs)
    if n_leaves == 0 or len(wires) != n_leaves or (
            scales is not None and len(scales) != n_leaves):
        raise ValueError(f"{n_leaves} accumulators, {len(wires)} wires: "
                         f"need as many, at least one")
    dev = accs[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    gpu = dev.index
    dtype = wires[0].dtype
    code = _wire_code(name, wires[0])
    ns = list(map(_T.numel, accs))
    if not (_same(accs, gpu, torch.float32) and min(ns) > 0):
        raise _first_bad("acc", [[a] for a in accs], gpu, torch.float32,
                         [max(n, 1) for n in ns])
    if not (_same(wires, gpu, dtype) and list(map(_T.numel, wires)) == ns):
        raise _first_bad("wire", [[x] for x in wires], gpu, dtype, ns)
    desc = [0] * (4 * n_leaves)
    desc[0::4] = list(map(_T.data_ptr, accs))
    desc[1::4] = list(map(_T.data_ptr, wires))
    desc[3::4] = ns
    if scales is not None:
        if not (_same(scales, gpu, torch.float32, contiguous=False)
                and set(map(_T.numel, scales)) == {1}):
            raise _first_bad("scale", [[s] for s in scales], gpu,
                             torch.float32, [1] * n_leaves)
        desc[2::4] = list(map(_T.data_ptr, scales))
    table = array.array("q", desc)
    base = table.buffer_info()[0]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        for lo in range(0, n_leaves, MAX_LEAVES):
            err = lib.agg_dequant_acc_leaves(
                base + 32 * lo, min(MAX_LEAVES, n_leaves - lo), code,
                float(weight), stream)
            _launched("dequant_acc", err)
            dequant_acc_leaves_kernel.launches += 1
    return list(accs)


def dequant_acc_kernel(acc: torch.Tensor, wire: torch.Tensor, weight: float,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc: (N,) fp32 on a CUDA device, UPDATED IN PLACE; wire: N elements
    int8/fp16/fp32; ``weight`` a Python number (rounded to fp32);
    ``scale``: a one-element fp32 tensor on the device (int8), or None for
    1.0.  -> ``acc`` holding ``acc + (w * s) * wire``.

    A one-leaf table: one launch of ``dequant_acc_leaves_kernel``, on the
    current stream; does not synchronise."""
    return dequant_acc_leaves_kernel([acc], [wire], weight,
                                     None if scale is None else [scale])[0]


def scatter_acc_leaves_kernel(accs: Sequence[torch.Tensor],
                              vals_list: Sequence[torch.Tensor],
                              idx_list: Sequence[torch.Tensor],
                              weight: float) -> List[torch.Tensor]:
    """A whole sparse fold: for each leaf ``l``, ``accs[l]`` ((N_l,) fp32
    on a CUDA device, UPDATED IN PLACE) takes ``w * vals_list[l]`` ((K_l,)
    fp32) added at ``idx_list[l]`` ((K_l,) int32 flat indices; colliding
    indices sum, indices outside ``[0, N_l)`` are dropped).  -> ``accs``.

    One launch for every ``MAX_LEAVES`` leaves, on the current stream; does
    not synchronise.  Raises on any input the kernel does not take and when
    a launch is refused."""
    if not (len(accs) == len(vals_list) == len(idx_list)) or not accs:
        raise ValueError(f"{len(accs)} accumulators, {len(vals_list)} value "
                         f"and {len(idx_list)} index wires: need as many, "
                         f"at least one")
    dev = accs[0].device
    if dev.type != "cuda":
        raise ValueError(f"scatter_acc_leaves_kernel needs CUDA tensors, got "
                         f"{dev}")
    # the checks run for every leaf of every fold: few attribute reads each
    desc = []
    for leaf, (acc, vals, idx) in enumerate(zip(accs, vals_list, idx_list)):
        if not acc.device == vals.device == idx.device == dev:
            raise ValueError(f"leaf {leaf}: acc on {acc.device}, vals on "
                             f"{vals.device}, idx on {idx.device}, not all "
                             f"on {dev}")
        if not (acc.is_contiguous() and vals.is_contiguous()
                and idx.is_contiguous()):
            raise ValueError(f"leaf {leaf}: a tensor is not contiguous")
        if acc.dtype != torch.float32 or vals.dtype != torch.float32:
            raise TypeError(f"leaf {leaf}: acc and vals must be float32")
        if idx.dtype != torch.int32:
            raise TypeError(f"leaf {leaf}: idx must be int32, got "
                            f"{idx.dtype}")
        if acc.dim() != 1 or vals.dim() != 1 or idx.shape != vals.shape:
            raise ValueError(f"leaf {leaf}: shapes {tuple(acc.shape)}, "
                             f"{tuple(vals.shape)}, {tuple(idx.shape)}: "
                             f"need (N,), (K,), (K,)")
        k, n = vals.numel(), acc.numel()
        if k == 0 or n == 0:
            raise ValueError(f"leaf {leaf}: empty accumulator or wire")
        desc += [acc.data_ptr(), vals.data_ptr(), idx.data_ptr(), k, n]
    lib = _lib()
    with torch.cuda.device(accs[0].device):
        stream = _stream(accs[0].device)
        for lo in range(0, len(accs), MAX_LEAVES):
            part = desc[5 * lo:5 * (lo + MAX_LEAVES)]
            err = lib.agg_scatter_acc_leaves(
                (ctypes.c_int64 * len(part))(*part), len(part) // 5,
                float(weight), stream)
            _launched("scatter_acc", err)
            scatter_acc_leaves_kernel.launches += 1
    return list(accs)


def scatter_acc_kernel(acc: torch.Tensor, vals: torch.Tensor,
                       idx: torch.Tensor, weight: float) -> torch.Tensor:
    """acc: (N,) fp32 on a CUDA device, UPDATED IN PLACE; vals: (K,) fp32;
    idx: (K,) int32 flat indices.  -> ``acc`` with ``w * vals`` added at
    ``idx`` (colliding indices sum; indices outside ``[0, N)`` dropped).

    A one-leaf table: one launch of ``scatter_acc_leaves_kernel``, on the
    current stream; does not synchronise."""
    return scatter_acc_leaves_kernel([acc], [vals], [idx], weight)[0]


# launches of each kernel in this process (a run reads them to show that
# its main path went through the kernels)
dequant_reduce_leaves_kernel.launches = 0
dequant_acc_leaves_kernel.launches = 0
scatter_acc_leaves_kernel.launches = 0
