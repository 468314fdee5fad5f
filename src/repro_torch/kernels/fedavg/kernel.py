"""Weighted parameter average as a hand-written CUDA kernel
(``repro_torch/csrc/fedavg.cu``), replacing the Pallas TPU kernel
``repro/kernels/fedavg/kernel.py:fedavg_kernel``.

One launch covers a round: :func:`fedavg_leaves_kernel` takes a table of
every (leaf, client) parameter of the round and reads each client's leaf
where it lies, so no caller stacks the clients' parameters into a (C, N)
copy first.  Each output element is one fmaf chain over the clients in
client order, from 0; more clients than a launch takes go in chunks that
continue the chain, with the same bits.  The one-stack function of the
reference's interface, :func:`fedavg_kernel`, is a table of one leaf whose
client rows are the stack's rows, and the launch count lives on
:func:`fedavg_leaves_kernel`.  The tables are built on the host by
:func:`build_tables`, a pure function of pointers and sizes.  The library
is built by ``nvcc`` at first use and called through ``ctypes``.
"""
from __future__ import annotations

import array
import ctypes
import functools
import operator
from itertools import accumulate, chain
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

BLOCK_ELEMS = 1024      # kBlockElems in fedavg.cu: a block's elements
MAX_CLIENTS = 16        # kClients: clients a launch
MAX_LEAVES = 32         # kLeaves: leaves a launch
MAX_ENTRIES = 384       # kEntries: (leaf, client) pairs a launch

_T = torch.Tensor
_dtype = operator.attrgetter("dtype")


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.load("fedavg").fedavg_leaves_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build_tables(x_ptrs: Sequence[int], out_ptrs: Sequence[int],
                 sizes: Sequence[int], n_clients: int
                 ) -> Tuple[array.array, List[Tuple[int, int, int, int]]]:
    """The launches of a round, as ``fedavg_leaves_f32`` takes them.

    ``x_ptrs``: the (leaf, client) parameter addresses, leaf-major (leaf
    ``l``, client ``c`` at ``l * n_clients + c``); ``out_ptrs`` and
    ``sizes``: each leaf's output address and element count.  Returns one
    ``array('q')`` holding every launch's table, and ``(offset, n, nc,
    c0)`` a launch in launch order: its table starts at word ``offset`` and
    covers ``n`` leaves and clients ``[c0, c0 + nc)``.  Clients go in
    chunks of ``MAX_CLIENTS`` in client order, each chunk's leaves in as few
    tables as the limits allow; leaves of no elements take no table.  A
    table is ``[x: n * nc] [out: n] [N: n] [first: n + 1] [vec]``: ``first``
    the leaves' first blocks of ``BLOCK_ELEMS`` elements, ``vec`` the mask
    of leaves whose N is a multiple of 4 and whose pointers are all 16-byte
    aligned."""
    live = [l for l, n in enumerate(sizes) if n > 0]
    if not live:
        return array.array("q"), []
    per = min(MAX_LEAVES, MAX_ENTRIES // min(n_clients, MAX_CLIENTS))
    words: List[int] = []
    launches = []
    for c0 in range(0, n_clients, MAX_CLIENTS):
        nc = min(MAX_CLIENTS, n_clients - c0)
        for i in range(0, len(live), per):
            group = live[i:i + per]
            rows = [x_ptrs[l * n_clients + c0:l * n_clients + c0 + nc]
                    for l in group]
            outs = [out_ptrs[l] for l in group]
            ns = [sizes[l] for l in group]
            # the vector path: N % 4 == 0 and the OR of the leaf's
            # addresses 16-byte aligned
            vec = 0
            for j, (n, o, row) in enumerate(zip(ns, outs, rows)):
                if not (n & 3 or functools.reduce(operator.or_, row, o) & 15):
                    vec |= 1 << j
            launches.append((len(words), len(group), nc, c0))
            words += chain.from_iterable(rows)
            words += outs
            words += ns
            words += accumulate([-(-n // BLOCK_ELEMS) for n in ns],
                                initial=0)
            words.append(vec)
    return array.array("q", words), launches


def _launch(x_ptrs: Sequence[int], out_ptrs: Sequence[int],
            sizes: Sequence[int], n_clients: int, w: torch.Tensor) -> None:
    """Every launch of a round's tables, on the current stream of ``w``'s
    device; counts each launch."""
    table, launches = build_tables(x_ptrs, out_ptrs, sizes, n_clients)
    if not launches:
        return
    base, w_ptr = table.buffer_info()[0], w.data_ptr()
    fn = _lib()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        for offset, n, nc, c0 in launches:
            err = fn(base + 8 * offset, n, nc, c0 > 0, w_ptr + 4 * c0,
                     stream)
            if err != 0:
                raise RuntimeError(f"fedavg kernel launch failed: CUDA error "
                                   f"{err}")
            fedavg_leaves_kernel.launches += 1


def _check_weights(name: str, w: torch.Tensor) -> None:
    if w.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {w.device}")
    if w.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 weights, got {w.dtype}")
    if w.dim() != 1 or w.numel() == 0 or not w.is_contiguous():
        raise ValueError(f"{name}: weights must be a contiguous (C,) tensor, "
                         f"C >= 1; got {tuple(w.shape)}")


def fedavg_leaves_kernel(outs: Sequence[torch.Tensor],
                         params_by_client: Sequence[Sequence[torch.Tensor]],
                         w: torch.Tensor) -> List[torch.Tensor]:
    """A whole round's reduce: ``outs[l]`` (fp32, N_l elements, any
    contiguous shape, on a CUDA device) is WRITTEN with ``sum_c w[c] *
    params_by_client[c][l]``, each client's leaf (fp32, contiguous, N_l
    elements, any shape) read where it lies.  ``w``: the (C,) fp32 weights
    on the same device, already normalised.  Leaves of no elements are
    left as they are.  -> ``outs``.

    One launch for the whole round while ``C <= MAX_CLIENTS`` and the
    (leaf, client) pairs fit one table; more take a launch a table (a
    chunk of ``MAX_CLIENTS`` clients continues the fmaf chain of the chunk
    before it, with the same bits).  On the current stream; does not
    synchronise.  Raises on any input the kernel does not take and when a
    launch is refused."""
    name = "fedavg_leaves_kernel"
    _check_weights(name, w)
    n_clients, n_leaves = w.numel(), len(outs)
    if n_leaves == 0 or len(params_by_client) != n_clients or any(
            len(ps) != n_leaves for ps in params_by_client):
        raise ValueError(f"{name}: {n_leaves} outputs, {n_clients} weights, "
                         f"leaves a client {[len(ps) for ps in params_by_client]}"
                         f": need one list of {n_leaves} >= 1 leaves a weight")
    xs = list(chain.from_iterable(params_by_client))
    everything = xs + list(outs)
    gpu = w.get_device()
    # a few calls into torch for the whole round: a Python loop over its
    # tensors costs more than the launch
    if set(map(_T.get_device, everything)) != {gpu}:
        raise ValueError(f"{name}: every tensor must be on {w.device}")
    if set(map(_dtype, everything)) != {torch.float32}:
        raise TypeError(f"{name} takes float32 tensors, got "
                        f"{sorted(set(map(str, map(_dtype, everything))))}")
    if not all(map(_T.is_contiguous, everything)):
        raise ValueError(f"{name}: every tensor must be contiguous")
    sizes = list(map(_T.numel, outs))
    if list(map(_T.numel, xs)) != sizes * n_clients:
        raise ValueError(f"{name}: a client's leaf sizes "
                         f"{[list(map(_T.numel, ps)) for ps in params_by_client]}"
                         f" differ from the outputs' {sizes}")
    ptrs = list(map(_T.data_ptr, xs))           # client-major
    x_ptrs = [0] * len(ptrs)                    # leaf-major
    for c in range(n_clients):
        x_ptrs[c::n_clients] = ptrs[c * n_leaves:(c + 1) * n_leaves]
    _launch(x_ptrs, list(map(_T.data_ptr, outs)), sizes, n_clients, w)
    return list(outs)


def fedavg_kernel(stacked: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """stacked: (C, N) fp32 client-major flat params on a CUDA device;
    weights: (C,) fp32 on the same device, summing to 1 -> (N,) fp32.

    A table of one leaf whose client rows are the stack's rows
    (``fedavg_leaves_kernel``'s launches): on the current stream, does not
    synchronise.  Raises on any input the kernel does not take (another
    device or dtype, a wrong shape, a non-contiguous tensor, an empty
    dimension) and when the launch is refused."""
    if stacked.device.type != "cuda":
        raise ValueError(f"fedavg_kernel needs a CUDA tensor, got "
                         f"{stacked.device}")
    _check_weights("fedavg_kernel", weights)
    if weights.device != stacked.device:
        raise ValueError(f"weights on {weights.device}, stacked on "
                         f"{stacked.device}")
    if stacked.dtype != torch.float32:
        raise TypeError(f"fedavg_kernel takes float32, got {stacked.dtype}")
    if stacked.dim() != 2 or weights.shape != (stacked.shape[0],):
        raise ValueError(f"shapes {tuple(stacked.shape)} and "
                         f"{tuple(weights.shape)}: need (C, N) and (C,)")
    if not stacked.is_contiguous():
        raise ValueError("fedavg_kernel needs a contiguous stack")
    c, n = stacked.shape
    if n == 0:
        raise ValueError(f"empty stack {tuple(stacked.shape)}")
    out = torch.empty((n,), dtype=torch.float32, device=stacked.device)
    base = stacked.data_ptr()
    _launch([base + 4 * n * k for k in range(c)], [out.data_ptr()], [n], c,
            weights)
    return out


# launches of the kernel in this process (a run reads it to show that its
# main path went through the kernel)
fedavg_leaves_kernel.launches = 0
