"""Roofline terms: of the port's kernels, counted from their shapes, and of
a whole LM step, counted by the dry run (``launch/dryrun.py``).  Port of
``repro/roofline/analysis.py``.

Kernels::

    compute_term = operations / the card's float32 peak
    memory_term  = bytes / the card's HBM bandwidth
    bound        = the larger of the two

The kernels compute in float32 on the CUDA cores, so the compute term uses
the float32 peak (the reference divides by the TPU's bf16 peak).  Bytes
count each input read once and each output written once, as the port's
kernels move them: boundary_fuse reads x once (its rows held on chip), the
agg_fuse reduce reads each client's wire where it lies, fedavg reads each
client's parameters in place.

A step (:class:`RooflineReport`, :func:`analyze_step`)::

    compute_term    = per_chip_flops / peak FLOP/s of the compute dtype
    memory_term     = per_chip_bytes_accessed / HBM bandwidth
    collective_term = per_chip_collective_bytes / one link's bandwidth

The reference reads these from XLA: ``cost_analysis()`` of the compiled
per-device program, ``memory_analysis()``, and the collectives in the
optimized HLO text (``cost_analysis_dict``, ``collective_bytes_from_hlo``).
The port has no compiler and no HLO, so the dry run counts instead
(:class:`StepTrace`, :func:`collective_bytes`, :func:`rank_bytes`):

* flops: ``torch.utils.flop_counter.FlopCounterMode`` over the real step
  on fake tensors (matrix products, convolutions, attention ops;
  elementwise work is not counted);
* bytes accessed: every dispatched op's tensor operands and results
  (views skipped), the eager step's traffic with no fusion;
* activation bytes: the peak of the live storages the step created
  (:class:`StepTrace`);
* a chip's share of these three: the global count times the share of the
  activations a chip holds, over the activations the step constrained
  (``sharding/specs.constrain``) weighted by their elements, or the batch
  input's share where it constrained none.  Work replicated across data
  ranks (a batch the data axes do not divide) is counted on each;
* parameter, optimizer and input bytes a rank: each leaf's bytes divided
  by the product of its spec's mesh-axis sizes;
* collective bytes a rank, from the parameters' shardings, in the
  reference's convention: the bytes of each collective's OUTPUT tensor on
  a chip, ring factors ignored.  In a train step, for each micro-batch,
  a leaf sharded over the data axes ("pod", "data": FSDP) costs two
  all-gathers over them (the forward's, and the backward's, which is the
  remat re-forward's) whose output is the leaf gathered over the data
  axes, still split over the others, and one reduce-scatter of its
  gradient whose output is the leaf's shard; a leaf replicated over data
  axes of more than one chip costs one all-reduce of its gradient (output
  the leaf's per-chip size).  A prefill or decode step costs one
  all-gather of each FSDP leaf.  Collectives of tensor and sequence
  parallelism on activations and the MoE all-to-all are not counted.
"""
from __future__ import annotations

import dataclasses
import json
import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline.hw import H100, HwSpec
from repro_torch.tree import leaves

Terms = Dict[str, Union[float, str]]

# operations a boundary element costs: qdq (int8: |x|, max, divide, round,
# two clamps, multiply; fp16: two conversions), the square-and-add of the
# norm, the scale and the noise fma
BOUNDARY_OPS = {"none": 5, "fp16": 7, "int8": 12}

_WIRE_BYTES = {"none": 4.0, "fp16": 2.0, "int8": 1.0}


def roofline_terms(flops: float, nbytes: float, hw: HwSpec = H100) -> Terms:
    """The compute and memory terms of ``flops`` float32 operations over
    ``nbytes`` of HBM traffic, and the bound: the larger, with which of
    the two it is (``"bytes"`` or ``"operations"``)."""
    compute = flops / hw.peak_flops_fp32
    memory = nbytes / hw.hbm_bw
    return {"flops": float(flops), "bytes_accessed": float(nbytes),
            "compute_term_s": compute, "memory_term_s": memory,
            "arithmetic_intensity": flops / nbytes if nbytes else 0.0,
            "bound_s": max(compute, memory),
            "bound_by": "bytes" if memory >= compute else "operations"}


def fedavg_terms(num_clients: int, n: int, *, hw: HwSpec = H100) -> Terms:
    """The fedavg reduce of ``num_clients`` fp32 rows of ``n`` elements:
    each row and the (C,) weights read once, the mean written once;
    one multiply-add an element of a row."""
    c, nn = float(num_clients), float(n)
    return {"num_clients": c, "n": nn,
            **roofline_terms(2.0 * c * nn, 4.0 * (c * nn + c + nn), hw)}


def dp_clip_terms(batch: int, n: int, *, hw: HwSpec = H100) -> Terms:
    """The DP-SGD release over a (B, N) fp32 per-example stack: the stack
    and the (N,) noise read once, the (N,) privatized sum written once;
    a square-and-add and a scale-and-add an element, one noise fma a
    column."""
    b, nn = float(batch), float(n)
    return {"batch": b, "n": nn,
            **roofline_terms(4.0 * b * nn + 2.0 * nn,
                             4.0 * (b * nn + 2.0 * nn), hw)}


def fused_boundary_terms(batch: int, features: int, *, codec: str = "int8",
                         hw: HwSpec = H100) -> Terms:
    """The fused boundary kernel (codec qdq + per-example clip + noise)
    over one flattened ``(batch, features)`` crossing: x and the noise
    read once, the output written once, all fp32 (``3 * 4 * B * N``
    bytes).  ``unfused_bytes_accessed`` is what three separate traversals
    (codec, clip norm, scale and noise), each a read and a write, move."""
    n = float(batch) * float(features)
    return {"codec": codec, "batch": float(batch),
            "features": float(features),
            **roofline_terms(BOUNDARY_OPS[codec] * n, 3.0 * 4.0 * n, hw),
            "unfused_bytes_accessed": 3.0 * 2.0 * 4.0 * n}


def agg_fuse_terms(num_clients: int, n: int, *, codec: str = "int8",
                   hw: HwSpec = H100) -> Terms:
    """The fused dequant-reduce (``kernels/agg_fuse``): ``num_clients``
    wires of ``n`` elements read once each at their wire width (1 B int8,
    2 B fp16, 4 B fp32) where they lie, the (C, 2) weight and scale
    coefficients read once, the fp32 mean written once:
    ``wire_b * C * N + 8 * C + 4 * N`` bytes; one fma an element of a
    wire.  ``unfused_bytes_accessed`` adds what decode-then-reduce moves
    besides: each client's fp32 decode written and read back."""
    wire_b = _WIRE_BYTES.get(codec, 4.0)
    c, nn = float(num_clients), float(n)
    return {"codec": codec, "num_clients": c, "n": nn,
            "wire_bytes_per_elem": wire_b,
            **roofline_terms(2.0 * c * nn, wire_b * c * nn + 8.0 * c
                             + 4.0 * nn, hw),
            "unfused_bytes_accessed": wire_b * c * nn + 8.0 * c * nn
                                      + 4.0 * nn}


# ---------------------------------------------------------------------------
# a whole step: the report, and what the dry run counts for it
# ---------------------------------------------------------------------------

@dataclass
class RooflineReport:
    """The reference's record of one (arch, shape, mesh) step, field for
    field; ``hlo_flops`` / ``hlo_bytes`` keep the reference's names and
    hold the dry run's per-chip counts."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives: Dict[str, float] = field(default_factory=dict)
    model_flops: float = 0.0            # 6*N*D (or 6*N_active*D for MoE)
    compute_term_s: float = 0.0
    memory_term_s: float = 0.0
    collective_term_s: float = 0.0
    arg_bytes_per_device: float = 0.0
    temp_bytes_per_device: float = 0.0
    out_bytes_per_device: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_term_s, "memory": self.memory_term_s,
                 "collective": self.collective_term_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS (global 6ND, divided per chip) / per-chip flops."""
        if not self.hlo_flops:
            return 0.0
        return (self.model_flops / self.chips) / self.hlo_flops

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["useful_flops_ratio"] = self.useful_flops_ratio
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def kernel_terms(flops: float, nbytes: float, hw: HwSpec = H100
                 ) -> Dict[str, float]:
    """Roofline terms of ONE kernel or program from its counted
    ``(flops, bytes)`` pair, against the tensor-core peak as the
    reference's (which reads the pair from ``cost_analysis``)."""
    flops, nbytes = float(flops), float(nbytes)
    return {"flops": flops, "bytes_accessed": nbytes,
            "compute_term_s": flops / hw.peak_flops_bf16,
            "memory_term_s": nbytes / hw.hbm_bw,
            "arithmetic_intensity": flops / nbytes if nbytes else 0.0}


def peak_flops(hw: HwSpec, compute_dtype: str) -> float:
    """The peak a step computing in ``compute_dtype`` divides by: the
    tensor cores' for bf16 / fp16, the CUDA cores' float32 peak else."""
    return (hw.peak_flops_bf16 if compute_dtype in ("bfloat16", "float16")
            else hw.peak_flops_fp32)


class StepTrace(TorchDispatchMode):
    """Counts what the ops dispatched inside it move: ``bytes_accessed``,
    each op's tensor operands and results (views skipped, in-place ops
    counted), and ``peak_bytes``, the most bytes that storages created
    inside it held at once (a storage is freed when its last tensor is;
    storages made before entering, such as a decode cache written in
    place, are not counted).  Works on fake tensors, whose storages have
    sizes and no memory."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._sizes: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live_bytes -= self._sizes.pop(key)

    def _track(self, storage) -> None:
        key = id(storage)
        if key in self._sizes:
            return
        n = storage.nbytes()
        self._sizes[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        in_storages = {id(t.untyped_storage()) for t in ins}
        if not func._schema.is_mutable and all(
                id(t.untyped_storage()) in in_storages for t in outs):
            return out                      # an alias (``_unsafe_view``)
        self.bytes_accessed += sum(t.numel() * t.element_size()
                                   for t in ins + outs)
        for t in outs:                      # a write in place makes none
            if id(t.untyped_storage()) not in in_storages:
                self._track(t.untyped_storage())
        return out


def shard_factor(sharding) -> int:
    """Over how many chips a sharding splits its tensor: the product of
    the mesh sizes of the axes its spec names."""
    n = 1
    for entry in sharding.spec:
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            n *= sharding.mesh.shape[a]
    return n


def rank_bytes(shapes, shardings) -> float:
    """Bytes a rank holds of a tree laid out by ``shardings``: each leaf's
    bytes over its :func:`shard_factor`."""
    return float(sum(s.nbytes / shard_factor(sh)
                     for s, sh in zip(leaves(shapes), leaves(shardings))))


DATA_AXES = ("pod", "data")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(pshapes, pshardings, *, train: bool,
                     microbatches: int = 1) -> Dict[str, float]:
    """Collective bytes a chip sends in one step, per kind, from the
    parameters' shardings (the convention of the module docstring):
    ``{kind: bytes, "count": collectives, "total": bytes}``."""
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    count = 0
    nmb = max(1, microbatches) if train else 1
    for s, sh in zip(leaves(pshapes), leaves(pshardings)):
        mesh = sh.mesh
        data = [a for a in DATA_AXES if a in mesh.shape]
        named = [a for e in sh.spec
                 for a in ((e,) if isinstance(e, str) else e or ())]
        sharded_over_data = math.prod(mesh.shape[a] for a in named
                                      if a in data)
        shard = s.nbytes / shard_factor(sh)
        gathered = shard * sharded_over_data
        if sharded_over_data > 1:
            gathers = 2 if train else 1
            out["all-gather"] += gathers * nmb * gathered
            count += gathers * nmb
            if train:
                out["reduce-scatter"] += nmb * shard
                count += nmb
        elif train and math.prod(mesh.shape[a] for a in data) > 1:
            out["all-reduce"] += nmb * shard
            count += nmb
    out["count"] = float(count)
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


@dataclass
class StepCounts:
    """What the dry run counts for one step on a mesh: the counterpart of
    the reference's compiled artifact with its cost and memory analyses.
    ``flops``, ``bytes_accessed`` and ``temp_bytes`` are the whole step's
    (a chip's share: :attr:`share`); the other byte fields are a chip's.
    Every field but ``share``'s inputs is affine in the number of layer
    periods and micro-batches, which the probes rely on."""
    chips: int
    flops: float
    bytes_accessed: float
    temp_bytes: float
    collectives: Dict[str, float]
    param_bytes: float
    opt_bytes: float
    input_bytes: float
    out_bytes: float
    act_elements: float = 0.0          # of the constrained activations
    act_elements_on_chip: float = 0.0  # their elements a chip holds
    batch_share: float = 1.0           # the batch input's share of a chip
    activations: List[Any] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def share(self) -> float:
        """A chip's share of the step's activations (and work): over the
        constrained activations, their elements on a chip over their
        elements; without any, the batch input's share."""
        if self.act_elements:
            return self.act_elements_on_chip / self.act_elements
        return self.batch_share

    @property
    def arg_bytes(self) -> float:
        return self.param_bytes + self.opt_bytes + self.input_bytes


def analyze_step(counts: StepCounts, *, arch: str, shape: str,
                 mesh_name: str, model_flops: float, hw: HwSpec = H100,
                 compute_dtype: str = "bfloat16") -> RooflineReport:
    """The reference's ``analyze_compiled``, over the dry run's counts of a
    step instead of an XLA artifact."""
    coll = counts.collectives
    flops = counts.flops * counts.share
    nbytes = counts.bytes_accessed * counts.share
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=counts.chips,
        hlo_flops=flops, hlo_bytes=nbytes,
        collective_bytes=float(coll["total"]), collectives=dict(coll),
        model_flops=model_flops,
        compute_term_s=flops / peak_flops(hw, compute_dtype),
        memory_term_s=nbytes / hw.hbm_bw,
        collective_term_s=float(coll["total"]) / hw.link_bw_per_link,
        arg_bytes_per_device=counts.arg_bytes,
        temp_bytes_per_device=counts.temp_bytes * counts.share,
        out_bytes_per_device=counts.out_bytes)
