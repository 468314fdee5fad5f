"""Compressed-domain server reduce as hand-written CUDA kernels
(``repro_torch/csrc/agg_fuse.cu``), replacing the Pallas TPU kernels of
``repro/kernels/agg_fuse/kernel.py``: ``dequant_reduce_kernel``,
``dequant_acc_kernel`` and ``scatter_acc_kernel`` (here also
``scatter_acc_leaves_kernel``: one launch for a whole fold's leaves).

Wires are int8, fp16 or fp32 and are read at that width; nothing
dequantised is written.  The accumulating kernels update ``acc`` in place,
as the JAX ops donate it, and return it.  An int8 wire's scale is a 0-dim
device tensor passed by pointer, so no call synchronises with the host.
Built by ``nvcc`` at first use and called through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import build

# dtype codes of agg_fuse.cu
WIRE_DTYPES = {torch.float32: 0, torch.float16: 1, torch.int8: 2}
MAX_CLIENTS = 12288     # kMaxClients in agg_fuse.cu
MAX_LEAVES = 64         # kMaxLeaves in agg_fuse.cu: leaves a scatter launch


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("agg_fuse")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.agg_dequant_reduce.argtypes = [p, ctypes.c_int, p, p, i64, i64, p]
    lib.agg_dequant_acc.argtypes = [p, p, ctypes.c_int, p, ctypes.c_float,
                                    i64, p]
    lib.agg_scatter_acc_leaves.argtypes = [p, ctypes.c_int, ctypes.c_float,
                                           p]
    for fn in (lib.agg_dequant_reduce, lib.agg_dequant_acc,
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dequant_reduce_kernel(wires: torch.Tensor, coefs: torch.Tensor
                          ) -> torch.Tensor:
    """wires: (C, N) int8/fp16/fp32 on a CUDA device; coefs: (C, 2) fp32
    ``[weight, scale]`` a client (weights already normalised) -> (N,) fp32
    ``sum_c w_c * s_c * wires[c]``.

    Launches on the current stream and does not synchronise.  Raises on any
    input the kernel does not take and when the launch is refused."""
    _check("dequant_reduce_kernel", wires, wires=wires, coefs=coefs)
    code = _wire_code("dequant_reduce_kernel", wires)
    if coefs.dtype != torch.float32:
        raise TypeError(f"coefs must be float32, got {coefs.dtype}")
    if wires.dim() != 2 or coefs.shape != (wires.shape[0], 2):
        raise ValueError(f"shapes {tuple(wires.shape)} and "
                         f"{tuple(coefs.shape)}: need (C, N) and (C, 2)")
    c, n = wires.shape
    if c == 0 or n == 0 or c > MAX_CLIENTS:
        raise ValueError(f"wires {tuple(wires.shape)}: need 1 <= C <= "
                         f"{MAX_CLIENTS} and N >= 1")
    out = torch.empty((n,), dtype=torch.float32, device=wires.device)
    with torch.cuda.device(wires.device):
        err = _lib().agg_dequant_reduce(
            wires.data_ptr(), code, coefs.data_ptr(), out.data_ptr(), c, n,
            _stream(wires))
    _launched("dequant_reduce", err)
    dequant_reduce_kernel.launches += 1
    return out


def dequant_acc_kernel(acc: torch.Tensor, wire: torch.Tensor, weight: float,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc: (N,) fp32 on a CUDA device, UPDATED IN PLACE; wire: (N,)
    int8/fp16/fp32; ``weight`` a Python number (rounded to fp32);
    ``scale``: a one-element fp32 tensor on the device (int8), or None for
    1.0.  -> ``acc`` holding ``acc + (w * s) * wire``.

    Launches on the current stream and does not synchronise."""
    tensors = dict(acc=acc, wire=wire)
    if scale is not None:
        tensors["scale"] = scale
    _check("dequant_acc_kernel", acc, **tensors)
    code = _wire_code("dequant_acc_kernel", wire)
    if acc.dtype != torch.float32 or (scale is not None
                                      and scale.dtype != torch.float32):
        raise TypeError("acc and scale must be float32")
    if acc.dim() != 1 or wire.shape != acc.shape or acc.numel() == 0:
        raise ValueError(f"shapes {tuple(acc.shape)} and "
                         f"{tuple(wire.shape)}: need two equal (N,), N >= 1")
    if scale is not None and scale.numel() != 1:
        raise ValueError(f"scale has {scale.numel()} elements, expected 1")
    with torch.cuda.device(acc.device):
        err = _lib().agg_dequant_acc(
            acc.data_ptr(), wire.data_ptr(), code,
            None if scale is None else scale.data_ptr(), float(weight),
            acc.numel(), _stream(acc))
    _launched("dequant_acc", err)
    dequant_acc_kernel.launches += 1
    return acc


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
        stream = _stream(accs[0])
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
dequant_reduce_kernel.launches = 0
dequant_acc_kernel.launches = 0
scatter_acc_leaves_kernel.launches = 0
