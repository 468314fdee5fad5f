"""Model splitting (paper §3.2/§4): the SplitPlan as the *executed* local
step.  Port of ``repro/core/split.py``: the sequential step, the
pipelined (1F1B) step over micro-batches, and the per-example staged step
DP-SGD trains through, each also over a stacked client axis for the
vectorized backend (``run_clients``, ``clients_value_and_grad``,
``clients_per_example_value_and_grad``).

A :class:`SplitPlan` records which device trains which contiguous layer
range of the discriminator.  :func:`split_forward` runs a forward portion
by portion with a hook at each device hand-off (what a LAN observer sees,
:func:`boundary_activations`).  :class:`SplitExecution` compiles a plan into a
staged ``value_and_grad``: the forward runs device segment by device
segment, the backward walks the same segments in reverse, and EVERY tensor
that crosses a segment boundary — the smashed activation on the way
forward, its gradient on the way back — passes through a
:class:`BoundaryStage` first.  With the identity stage the gradient is the
monolithic one bit for bit; codec stages (``fed/transport``) and Gaussian
clip+noise stages model lossy / noisy LAN links.  Stages are applied
straight-through (never differentiated): they model the wire, not the math.

The same object prices what it executes: ``step_wire_bytes`` measures the
per-boundary LAN payload of one local step, which
``core/simulate.plan_epoch_time`` consumes in place of the paper's fixed
hop constant and ``fed/transport.TrafficLedger`` records per round.

Per-example noise: the reference draws each example's stage noise from its
own key (``fold_in(key, i)`` under ``jax.vmap``).  The port's per-example
step draws ONE ``(B, N)`` normal per crossing from the crossing's key,
which does not depend on the example, and row ``i`` is example ``i``'s
noise: one generator a crossing instead of B.  The streams differ from
the reference's by construction; the contract — independent noise per
example, per crossing, per step — is the same.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import keys
from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclass(frozen=True)
class Portion:
    """A contiguous run of layers assigned to one device."""
    device_id: str
    layer_names: Tuple[str, ...]
    cost: float                 # sum of layer costs (compute units)


@dataclass
class SplitPlan:
    client_id: str
    portions: List[Portion] = field(default_factory=list)

    @property
    def num_boundaries(self) -> int:
        """Device-to-device hand-offs along the chain (LAN hops, fwd)."""
        n = 0
        for a, b in zip(self.portions, self.portions[1:]):
            if a.device_id != b.device_id:
                n += 1
        return n

    def layers_in_order(self) -> List[str]:
        return [n for p in self.portions for n in p.layer_names]

    def device_loads(self) -> Dict[str, float]:
        loads: Dict[str, float] = {}
        for p in self.portions:
            loads[p.device_id] = loads.get(p.device_id, 0.0) + p.cost
        return loads

    def validate(self, layer_names: Sequence[str]) -> None:
        got = self.layers_in_order()
        if got != list(layer_names):
            raise ValueError(
                f"split plan does not cover the model in order:\n"
                f"  expected {list(layer_names)}\n  got      {got}")


class InfeasibleSplit(Exception):
    """Client lacks capacity to host the model (paper: client is dropped)."""


# ---------------------------------------------------------------------------
# split execution — numerically identical to the unsplit forward
# ---------------------------------------------------------------------------

def split_forward(x, plan: SplitPlan,
                  apply_layer: Callable[[str, Any], Any],
                  boundary_hook: Optional[Callable[[int, str, str, Any],
                                                   None]] = None):
    """Run a forward pass portion by portion, as the devices would.

    ``apply_layer(name, x) -> x`` applies one named layer.  The boundary is
    a list hop, so the result is the monolithic forward bit for bit.
    ``boundary_hook(boundary_idx, from_device, to_device, activation)`` is
    called at every device-to-device hand-off with the activation that
    would cross the LAN: the observation point of the activation-inversion
    attack (``privacy/attacks.py``)."""
    n_boundary = 0
    for pi, portion in enumerate(plan.portions):
        for name in portion.layer_names:
            x = apply_layer(name, x)
        if boundary_hook is not None and pi + 1 < len(plan.portions):
            nxt = plan.portions[pi + 1]
            if nxt.device_id != portion.device_id:
                boundary_hook(n_boundary, portion.device_id,
                              nxt.device_id, x)
                n_boundary += 1
    return x


def boundary_activations(x, plan: SplitPlan,
                         apply_layer: Callable[[str, Any], Any]
                         ) -> List[Tuple[int, str, str, Any]]:
    """All (boundary_idx, from_device, to_device, activation) tuples a LAN
    observer sees during one split forward pass."""
    seen: List[Tuple[int, str, str, Any]] = []
    split_forward(x, plan, apply_layer,
                  boundary_hook=lambda i, a, b, act: seen.append(
                      (i, a, b, act)))
    return seen


def plan_segments(plan: SplitPlan) -> List[Tuple[str, Tuple[str, ...]]]:
    """Merge consecutive same-device portions into *device segments*.

    A segment is the unit of staged execution: activations only cross the
    LAN between segments, so ``len(segments) - 1 == plan.num_boundaries``.
    """
    segs: List[Tuple[str, Tuple[str, ...]]] = []
    for p in plan.portions:
        if segs and segs[-1][0] == p.device_id:
            segs[-1] = (p.device_id, segs[-1][1] + p.layer_names)
        else:
            segs.append((p.device_id, p.layer_names))
    return segs


@dataclass(frozen=True)
class Boundary:
    """One LAN hand-off in the executed chain."""
    index: int
    from_device: str
    to_device: str
    depth: int                  # layers applied before the hand-off


def partition_params(plan: SplitPlan, params) -> List[Dict[str, Any]]:
    """Partition a {layer_name: subtree} param tree by portion: what each
    device actually holds.  Layers absent from ``params`` are skipped."""
    return [{n: params[n] for n in p.layer_names if n in params}
            for p in plan.portions]


def tensor_wire_bytes(shape: Sequence[int],
                      dtype: torch.dtype = torch.float32) -> int:
    """Native payload bytes of one boundary tensor (identity wire)."""
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# boundary stages
# ---------------------------------------------------------------------------

class BoundaryStage:
    """What happens to a tensor as it crosses a segment boundary.

    ``apply(x, key)`` transforms the tensor (identity here); ``wire_bytes``
    prices what the transformed tensor costs on the LAN.  Stages are
    straight-through: the backward pass applies the stage to the crossing
    *gradient* but never differentiates through the stage itself.
    """
    name = "identity"
    stochastic = False          # True => ``apply`` consumes the key

    @property
    def signature(self) -> Tuple:
        """Step identity: stages with equal signatures run the same staged
        step (``fed/programs.LocalProgram`` dedups on this)."""
        return (self.name,)

    def apply(self, x: torch.Tensor, key=None) -> torch.Tensor:
        del key
        return x

    def apply_per_example(self, x: torch.Tensor, key=None,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """The stage applied to each example (row of ``x``) alone, as
        ``apply`` on ``x[i:i+1]`` would.  A stochastic stage gives example
        ``i`` row ``i`` of one ``(B, N)`` normal drawn from ``key``, or of
        ``noise`` when given (the module's per-example noise contract)."""
        del key, noise
        return x

    def wire_bytes(self, shape: Sequence[int],
                   dtype: torch.dtype = torch.float32) -> int:
        return tensor_wire_bytes(shape, dtype)


class CodecBoundaryStage(BoundaryStage):
    """Run each boundary tensor through a transport codec round-trip: the
    downstream device computes on what a compressed LAN link delivers.
    Only stateless codecs qualify — ``make_boundary_stage`` builds top-k
    without error feedback."""
    stochastic = False

    def __init__(self, codec):
        if getattr(codec, "error_feedback", False):
            raise ValueError(
                "stateful codecs (top-k error feedback) cannot run as a "
                "boundary stage; build with error_feedback=False")
        self.codec = codec
        self.name = codec.name

    @property
    def signature(self) -> Tuple:
        return (self.name, float(getattr(self.codec, "frac", 0.0)))

    def apply(self, x: torch.Tensor, key=None) -> torch.Tensor:
        del key
        dec, _ = self.codec.roundtrip(x)
        return dec

    def apply_per_example(self, x: torch.Tensor, key=None,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """int8: one scale a row; top-k: k of each row; the elementwise
        codecs as ``apply``."""
        del key, noise
        if self.name not in ("int8", "topk"):
            return self.apply(x)
        flat = x.reshape(x.shape[0], -1).to(torch.float32)
        if self.name == "int8":
            from repro_torch.kernels.boundary_fuse.ref import codec_qdq
            out = codec_qdq(flat, "int8", amax="row")
        else:
            from repro_torch.fed.transport import _topk_k
            k = _topk_k(flat.shape[1], self.codec.frac)
            idx = torch.topk(torch.abs(flat), k, dim=1).indices
            out = flat * torch.zeros_like(flat).scatter_(1, idx, 1.0)
        return out.reshape(x.shape).to(x.dtype)

    def wire_bytes(self, shape: Sequence[int],
                   dtype: torch.dtype = torch.float32) -> int:
        _, nbytes = self.codec.roundtrip(torch.zeros(tuple(shape),
                                                     dtype=dtype))
        return int(nbytes)


class GaussianBoundaryStage(BoundaryStage):
    """Per-example clip + Gaussian noise on every crossing tensor — the
    split-learning analogue of DP-SGD's privatized release, applied to the
    smashed activation (fwd) and its gradient (bwd)."""
    name = "dp"
    stochastic = True

    def __init__(self, clip: float, sigma: float):
        self.clip = float(clip)
        self.sigma = float(sigma)

    @property
    def signature(self) -> Tuple:
        return (self.name, self.clip, self.sigma)

    def apply(self, x: torch.Tensor, key=None) -> torch.Tensor:
        return self.apply_per_example(x, key)

    def apply_per_example(self, x: torch.Tensor, key=None,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Already per row: each row's clip, row ``i`` of the draw."""
        flat = x.reshape(x.shape[0], -1).to(torch.float32)
        norms = torch.linalg.vector_norm(flat, dim=1)
        scale = torch.clamp(self.clip / torch.clamp(norms, min=1e-12),
                            max=1.0)
        y = flat * scale[:, None]
        if self.sigma > 0.0 and (key is not None or noise is not None):
            if noise is None:
                noise = keys.normal(key, y.shape, y.device)
            y = y + self.sigma * self.clip * noise
        return y.reshape(x.shape).to(x.dtype)


class ComposedBoundaryStage(BoundaryStage):
    """Sequential composition of boundary stages (applied in listed order,
    e.g. ``int8+dp`` = codec round-trip, then clip+noise).  Wire pricing
    uses the first codec stage in the chain; the step key goes to every
    sub-stage unchanged, so at most one stochastic stage may appear."""

    def __init__(self, stages: Sequence[BoundaryStage]):
        self.stages_seq = list(stages)
        if sum(1 for s in self.stages_seq if s.stochastic) > 1:
            raise ValueError("at most one stochastic stage per composition")
        self.name = "+".join(s.name for s in self.stages_seq)
        self.stochastic = any(s.stochastic for s in self.stages_seq)

    @property
    def signature(self) -> Tuple:
        return ("compose",) + tuple(s.signature for s in self.stages_seq)

    def apply(self, x: torch.Tensor, key=None) -> torch.Tensor:
        for s in self.stages_seq:
            x = s.apply(x, key)
        return x

    def apply_per_example(self, x: torch.Tensor, key=None,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        for s in self.stages_seq:
            x = s.apply_per_example(x, key, noise)
        return x

    def wire_bytes(self, shape: Sequence[int],
                   dtype: torch.dtype = torch.float32) -> int:
        for s in self.stages_seq:
            if isinstance(s, CodecBoundaryStage):
                return s.wire_bytes(shape, dtype)
        return tensor_wire_bytes(shape, dtype)


class FusedBoundaryStage(BoundaryStage):
    """``codec + dp`` in ONE traversal: quantize/dequantize, per-example
    clip and Gaussian noise fused (``kernels/boundary_fuse``; the CUDA
    kernel with ``use_kernel`` on the GPU).  It draws the same noise as the
    composed stage for the same key, so fused == composed per sample.
    Fusable codecs are the elementwise ones; top-k stays composed."""

    FUSABLE = ("none", "fp16", "int8")
    stochastic = True

    def __init__(self, codec_name: str, clip: float, sigma: float, *,
                 use_kernel: bool = False):
        if codec_name not in self.FUSABLE:
            raise ValueError(f"codec {codec_name!r} is not fusable "
                             f"(expected one of {self.FUSABLE})")
        self.codec_name = codec_name
        self.clip = float(clip)
        self.sigma = float(sigma)
        self.use_kernel = bool(use_kernel)
        self.name = "dp" if codec_name == "none" else f"{codec_name}+dp"

    @property
    def signature(self) -> Tuple:
        return ("fused", self.codec_name, self.clip, self.sigma,
                self.use_kernel)

    def apply(self, x: torch.Tensor, key=None) -> torch.Tensor:
        return self._fused(x, key, None, "tensor")

    def apply_per_example(self, x: torch.Tensor, key=None,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """ONE fused launch for the whole batch with a per-row int8 amax."""
        return self._fused(x, key, noise, "row")

    def _fused(self, x, key, noise, amax: str) -> torch.Tensor:
        from repro_torch.kernels.boundary_fuse.ops import fused_boundary_flat
        flat = x.reshape(x.shape[0], -1).to(torch.float32).contiguous()
        noise_scale = 0.0
        if self.sigma > 0.0 and (key is not None or noise is not None):
            noise_scale = self.sigma * self.clip
            if noise is None:
                noise = keys.normal(key, flat.shape, flat.device)
        else:
            noise = torch.zeros_like(flat)
        y = fused_boundary_flat(flat, self.clip, noise_scale, noise,
                                codec=self.codec_name, amax=amax,
                                use_kernel=self.use_kernel)
        return y.reshape(x.shape).to(x.dtype)

    def wire_bytes(self, shape: Sequence[int],
                   dtype: torch.dtype = torch.float32) -> int:
        if self.codec_name == "none":
            return tensor_wire_bytes(shape, dtype)
        from repro_torch.fed.transport import make_codec
        _, nbytes = make_codec(self.codec_name).roundtrip(
            torch.zeros(tuple(shape), dtype=dtype))
        return int(nbytes)


def make_boundary_stage(split_cfg, name: Optional[str] = None
                        ) -> BoundaryStage:
    """Factory keyed by ``config.SplitConfig.boundary_stage``; ``name``
    overrides it.  Composed names (``"fp16+dp"``, ``"int8+dp"``,
    ``"topk+dp"``) chain stages in order; a fusable codec followed by
    ``dp`` takes the fused stage unless ``split_cfg.fuse_boundary`` is
    off."""
    if name is None:
        name = getattr(split_cfg, "boundary_stage", "identity")
    if "+" in name:
        parts = [p for p in name.split("+") if p]
        if (len(parts) == 2 and parts[1] == "dp"
                and parts[0] in FusedBoundaryStage.FUSABLE
                and getattr(split_cfg, "fuse_boundary", True)):
            return FusedBoundaryStage(
                parts[0], split_cfg.stage_clip, split_cfg.stage_sigma,
                use_kernel=getattr(split_cfg, "use_kernel", False))
        return ComposedBoundaryStage(
            [make_boundary_stage(split_cfg, p) for p in parts])
    if name in ("", "identity", "none"):
        return BoundaryStage()
    if name == "dp":
        return GaussianBoundaryStage(split_cfg.stage_clip,
                                     split_cfg.stage_sigma)
    from repro_torch.fed.transport import make_codec
    return CodecBoundaryStage(make_codec(
        name, topk_frac=getattr(split_cfg, "topk_frac", 0.01),
        error_feedback=False))


# ---------------------------------------------------------------------------
# the executed split
# ---------------------------------------------------------------------------

class SplitExecution:
    """A :class:`SplitPlan` compiled into the executed local training step.

    ``apply_layer(name, params, x) -> x`` applies one named layer;
    ``tails`` is one scalar loss tail per forward pass (the GAN D loss is
    two passes: BCE(real, 1) and BCE(fake, 0)).  Both passes traverse the
    SAME boundaries per step.

    Under the identity stage ``value_and_grad`` is bit-exact with the
    monolithic gradient: each segment's forward is recorded by autograd
    from a boundary input detached and re-leafed, its backward runs the
    same operations the monolithic backward runs, and the cotangent chain
    crosses the boundaries where the activations did.
    """

    def __init__(self, plan: SplitPlan, apply_layer, tails: Sequence, *,
                 stage: Optional[BoundaryStage] = None,
                 stages: Optional[Sequence[BoundaryStage]] = None,
                 pipeline_microbatches: int = 1):
        """``stage`` applies one stage at every boundary; ``stages`` assigns
        one per boundary (index-aligned with ``self.boundaries``).

        ``pipeline_microbatches`` > 1 makes ``value_and_grad`` run the
        1F1B-pipelined step (``run_pipelined``) over that many
        micro-batches a batch, priced by ``overlap_schedule``."""
        self.plan = plan
        self.apply_layer = apply_layer
        self.tails = tuple(tails)
        self.stage = stage or BoundaryStage()
        self.pipeline_microbatches = max(1, int(pipeline_microbatches))
        self.segments = plan_segments(plan)
        self.boundaries: List[Boundary] = []
        depth = 0
        for i, (dev, names) in enumerate(self.segments[:-1]):
            depth += len(names)
            self.boundaries.append(Boundary(
                i, dev, self.segments[i + 1][0], depth))
        if stages is None:
            self.stages: List[BoundaryStage] = \
                [self.stage] * len(self.boundaries)
        else:
            self.stages = list(stages)
            if len(self.stages) != len(self.boundaries):
                raise ValueError(
                    f"{len(self.stages)} stages for "
                    f"{len(self.boundaries)} boundaries")
        self._shape_cache: Dict[Tuple, List[Tuple[int, ...]]] = {}

    # ------------------------------------------------------------------
    @property
    def num_boundaries(self) -> int:
        return len(self.boundaries)

    @property
    def num_passes(self) -> int:
        return len(self.tails)

    @property
    def stochastic(self) -> bool:
        """True when ANY boundary's stage consumes the noise key."""
        return any(s.stochastic for s in self.stages)

    @property
    def signature(self) -> Tuple:
        """Step key: plans with the same boundary depths and the same
        per-boundary stages run the same staged step — device identity
        only affects pricing, never math.  A pipelined execution carries
        ``("pipeline", K)``."""
        base = (tuple(b.depth for b in self.boundaries),
                tuple(s.signature for s in self.stages))
        if self.pipeline_microbatches > 1:
            return base + (("pipeline", self.pipeline_microbatches),)
        return base

    def _key(self, key, b: int, p: int, direction: int):
        """Per-(boundary, pass, direction) stage key, distinct within one
        step (direction: 0 fwd, 1 bwd)."""
        if key is None:
            return None
        return keys.fold_in(key, 1 + (b * self.num_passes + p) * 2
                            + direction)

    def _segment(self, names, params, xs):
        out = []
        for x in xs:
            for n in names:
                x = self.apply_layer(n, params, x)
            out.append(x)
        return tuple(out)

    # ------------------------------------------------------------------
    def _check_passes(self, batches) -> None:
        if len(batches) != self.num_passes:
            raise ValueError(f"{len(batches)} batches for "
                             f"{self.num_passes} loss tails")

    def _default_key(self, key):
        # a stochastic stage never runs keyless-and-noiseless
        if key is None and self.stochastic:
            return keys.root(keys.DEFAULT, 0)
        return key

    def run(self, params, batches: Sequence[torch.Tensor], key=None,
            collect: bool = False, cross=None):
        """One staged forward+backward over per-pass ``batches``.

        Returns ``(loss, grads, records)``; ``records`` (when ``collect``)
        holds the staged tensors that crossed each boundary:
        ``records["fwd"][b][p]`` / ``records["bwd"][b][p]``.  ``cross``,
        given, replaces each crossing's stage call:
        ``cross(boundary, pass, direction, x) -> x``.
        """
        self._check_passes(batches)
        key = self._default_key(key)
        if cross is None:
            def cross(si, p, direction, x):
                return self.stages[si].apply(
                    x, self._key(key, si, p, direction))

        def loss_of(zs):
            loss = sum(tail(z) for tail, z in zip(self.tails, zs))
            return loss, loss
        return self._staged(params, batches, cross, self._segment, loss_of,
                            collect)

    def run_clients(self, params, batches: Sequence[torch.Tensor],
                    client_keys: Optional[Sequence] = None):
        """``run`` over a leading client axis: every parameter leaf and
        batch ``(C, ...)``, one noise key a client.  Each segment's forward
        is ``torch.func.vmap`` over clients; each crossing applies the
        stage per client, on its row, with that client's key (an int8
        amax belongs to one client's crossing: one stage call, one
        boundary_fuse launch, a crossing a client, as the loop).  The
        summed client losses are differentiated, so each client's rows of
        the gradient are its own.  Returns ``(losses (C,), grads)``."""
        self._check_passes(batches)
        ks = self._client_keys(client_keys, int(batches[0].shape[0]))

        def cross(si, p, direction, x):
            stage = self.stages[si]
            return torch.stack([stage.apply(
                x[c], self._key(k, si, p, direction))
                for c, k in enumerate(ks)])

        vmap = torch.func.vmap

        def segment(names, tree, xs):
            return vmap(lambda q, ys: self._segment(names, q, ys))(tree, xs)

        def loss_of(zs):
            per = sum(vmap(tail)(z) for tail, z in zip(self.tails, zs))
            return per.sum(), per
        losses, grads, _ = self._staged(params, batches, cross, segment,
                                        loss_of, False)
        return losses, grads

    def _client_keys(self, client_keys, c: int) -> List:
        if client_keys is None:
            return [self._default_key(None)] * c
        return [self._default_key(k) for k in client_keys]

    def _staged(self, params, batches, cross, segment, loss_of,
                collect: bool):
        """The staged step behind ``run`` and ``run_clients``:
        ``segment(names, tree, xs)`` applies one device segment to every
        pass, ``loss_of(last outputs) -> (loss to differentiate, loss to
        report)``."""
        records = {"fwd": [None] * self.num_boundaries,
                   "bwd": [None] * self.num_boundaries}
        flat = leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in flat]
            tree = unflatten_like(params, live)
            xs = tuple(batches)
            seg_in, seg_out = [], []
            last = len(self.segments) - 1
            for si, (dev, names) in enumerate(self.segments):
                if si > 0:
                    xs = tuple(x.detach().requires_grad_(True) for x in xs)
                seg_in.append(xs)
                outs = segment(names, tree, xs)
                seg_out.append(outs)
                if si < last:
                    with torch.no_grad():
                        xs = tuple(cross(si, p, 0, x.detach())
                                   for p, x in enumerate(outs))
                    if collect:
                        records["fwd"][si] = xs
            loss, report = loss_of(seg_out[-1])
        grads: List[Optional[torch.Tensor]] = [None] * len(live)
        g_act = None
        for si in range(last, -1, -1):
            # each segment's backward: its parameters' gradients (None for
            # parameters it does not use) and the cotangent of its input
            ins = list(seg_in[si]) if si > 0 else []
            if si == last:
                outputs, grad_outputs = [loss], None
            else:
                outputs, grad_outputs = list(seg_out[si]), list(g_act)
            got = torch.autograd.grad(outputs, live + ins,
                                      grad_outputs=grad_outputs,
                                      allow_unused=True)
            for i, g in enumerate(got[:len(live)]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            if si > 0:
                with torch.no_grad():
                    g_act = tuple(cross(si - 1, p, 1, g)
                                  for p, g in enumerate(got[len(live):]))
                if collect:
                    records["bwd"][si - 1] = g_act
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return report.detach(), unflatten_like(params, grads), records

    def run_pipelined(self, params, batches: Sequence[torch.Tensor],
                      key=None, collect: bool = False,
                      num_microbatches: Optional[int] = None):
        """The 1F1B-pipelined local step: each pass's batch split into K
        equal micro-batches, the staged chain run per micro-batch, so on
        several devices segment ``s`` of micro-batch ``m`` overlaps
        segment ``s+1`` of micro-batch ``m-1`` (what ``overlap_schedule``
        prices; one card runs them one after another).  Loss and grads
        are summed in micro-batch order and scaled by ``1/K``: the mean of
        the per-micro-batch steps (batch norm sees per-micro-batch
        statistics, the usual shift of gradient accumulation).

        ``K = 1`` (or a batch K does not divide: clamped to a divisor by
        ``core.pipeline.effective_microbatches``) is ``run`` unchanged.
        Micro-batch ``m``'s stage key is ``fold_in(key, m)``.  With
        ``collect``, each boundary's records are concatenated back to the
        full-batch view."""
        self._check_passes(batches)
        k = self._microbatches(batches, 0, num_microbatches)
        if k == 1:
            return self.run(params, batches, key, collect)
        key = self._default_key(key)
        loss, grads, recs = self._pipelined(
            batches, k, 0, lambda chunk, m: self.run(
                params, chunk, None if key is None else keys.fold_in(key, m),
                collect))
        records = {"fwd": [None] * self.num_boundaries,
                   "bwd": [None] * self.num_boundaries}
        if collect:
            for d in ("fwd", "bwd"):
                for b in range(self.num_boundaries):
                    records[d][b] = tuple(
                        torch.cat([r[d][b][p] for r in recs], dim=0)
                        for p in range(self.num_passes))
        return loss, grads, records

    def _microbatches(self, batches, axis: int,
                      num_microbatches: Optional[int] = None) -> int:
        from repro_torch.core.pipeline import effective_microbatches
        req = self.pipeline_microbatches if num_microbatches is None \
            else int(num_microbatches)
        return effective_microbatches(
            min(int(b.shape[axis]) for b in batches), req)

    @staticmethod
    def _pipelined(batches, k: int, axis: int, run_one):
        """``run_one(chunk, m) -> (loss, grads, records)`` over K equal
        micro-batches of ``batches`` along ``axis``; the summed loss and
        grads scaled by ``1/K``, and each micro-batch's records."""
        mb = min(int(b.shape[axis]) for b in batches) // k
        loss = grads = None
        recs = []
        for m in range(k):
            chunk = tuple(b.narrow(axis, m * mb, mb) for b in batches)
            l, g, r = run_one(chunk, m)
            loss = l if loss is None else loss + l
            grads = g if grads is None else tree_map(torch.add, grads, g)
            recs.append(r)
        inv = 1.0 / k
        return loss * inv, tree_map(lambda g: g * inv, grads), recs

    def value_and_grad(self, params, real, fake, key=None):
        """The D-loss contract of ``fed/programs.make_local_step``:
        ``(params, real, fake, key) -> (loss, grads)`` through the staged
        execution, pipelined when ``pipeline_microbatches > 1``."""
        if self.pipeline_microbatches > 1:
            loss, grads, _ = self.run_pipelined(params, (real, fake), key)
        else:
            loss, grads, _ = self.run(params, (real, fake), key)
        return loss, grads

    def clients_value_and_grad(self, params, real, fake, client_keys=None):
        """``value_and_grad`` over a leading client axis (the vectorized
        backend's step): ``(losses (C,), stacked grads)`` from
        ``run_clients``, pipelined as ``run_pipelined`` pipelines ``run``
        (micro-batch ``m`` of client ``c`` keyed ``fold_in(key_c, m)``)."""
        batches = (real, fake)
        k = self._microbatches(batches, 1)
        if k == 1:
            return self.run_clients(params, batches, client_keys)
        ks = self._client_keys(client_keys, int(real.shape[0]))

        def run_one(chunk, m):
            mkeys = [None if key is None else keys.fold_in(key, m)
                     for key in ks]
            return self.run_clients(params, chunk, mkeys) + (None,)
        loss, grads, _ = self._pipelined(batches, k, 1, run_one)
        return loss, grads

    # ------------------------------------------------------------------
    # the per-example staged step (DP-SGD through the split)
    # ------------------------------------------------------------------
    def _segment_one(self, names):
        """A segment applied to ONE example of each pass (no batch axis),
        as a batch of one: what ``torch.func.vmap`` maps over examples."""
        def seg(params, xs):
            return tuple(o[0] for o in self._segment(
                names, params, tuple(x[None] for x in xs)))
        return seg

    def per_example_value_and_grad(self, params, real, fake, key=None):
        """DP-SGD's per-example step through the split: ``(losses (B,),
        grads)`` with every gradient leaf ``(B, ...)``, example ``i``'s
        loss and gradient as ``run`` on ``(real[i:i+1], fake[i:i+1])``
        computes them, batch norm and the int8 amax included.

        The stages stay outside the vmap.  Each segment's forward is
        ``torch.func.vmap`` over examples; its backward is the vmap of the
        segment's ``torch.func.vjp``, which recomputes its forward; each
        crossing applies its stage's per-example form once to the whole
        ``(B, ...)`` tensor (the fused stage: one boundary_fuse launch
        with a per-row amax), with the module's per-example noise
        contract.  K plays no part: a batch of one is never pipelined."""
        key = self._default_key(key)

        def cross(si, p, direction, x):
            return self.stages[si].apply_per_example(
                x, self._key(key, si, p, direction))

        return self._per_example((real, fake), params, cross,
                                 lambda fn, dims: torch.func.vmap(
                                     fn, in_dims=dims), 1)

    def clients_per_example_value_and_grad(self, params, real, fake,
                                           client_keys=None):
        """``per_example_value_and_grad`` over a leading client axis:
        ``(losses (C, B), grads)`` with every gradient leaf ``(C, B,
        ...)``.  The segment vmaps nest (clients outside, examples
        inside); each crossing applies the stage's per-example form ONCE
        to the group's ``(C·B, ...)`` rows (the fused stage: one
        ``amax="row"`` boundary_fuse launch a crossing for the group), its
        noise each client's ``(B, N)`` draw from that client's crossing
        key, concatenated: the loop's noise row for row."""
        c, b = int(real.shape[0]), int(real.shape[1])
        ks = self._client_keys(client_keys, c)

        def cross(si, p, direction, x):
            stage, noise = self.stages[si], None
            if stage.stochastic:
                noise = self.group_noise(ks, si, p, direction, b,
                                         x[0, 0].numel(), x.device)
            y = stage.apply_per_example(
                x.reshape((c * b,) + tuple(x.shape[2:])), noise=noise)
            return y.reshape(x.shape)

        vmap = torch.func.vmap
        return self._per_example(
            (real, fake), params, cross,
            lambda fn, dims: vmap(vmap(fn, in_dims=dims)), 2)

    def group_noise(self, client_keys, si: int, p: int, direction: int,
                    b: int, n: int, device) -> torch.Tensor:
        """The ``(C·B, n)`` noise of one per-example crossing over a
        client group: each client's ``(b, n)`` draw from its crossing key,
        concatenated in client order."""
        return torch.cat([keys.normal(self._key(k, si, p, direction),
                                      (b, n), device)
                          for k in client_keys])

    def _per_example(self, batches, params, cross, mapped, lead: int):
        """The per-example staged step behind both forms: ``mapped(fn,
        in_dims)`` maps a one-example function over the ``lead`` leading
        data axes (params ``in_dims`` None over examples),
        ``cross(boundary, pass, direction, x)`` applies a crossing's stage
        to the whole mapped tensor."""
        self._check_passes(batches)
        last = len(self.segments) - 1
        held = tree_map(torch.Tensor.detach, params)
        subs = [{n: held[n] for n in names if n in held}
                for _, names in self.segments]
        xs = tuple(batches)
        seg_in = []
        with torch.no_grad():
            for si in range(last):
                seg_in.append(xs)
                outs = mapped(self._segment_one(self.segments[si][1]),
                              (None, 0))(subs[si], xs)
                xs = tuple(cross(si, p, 0, o) for p, o in enumerate(outs))
        tail_seg = self._segment_one(self.segments[last][1])

        def loss_one(p, xs):
            zs = tail_seg(p, xs)
            return sum(tail(z[None]) for tail, z in zip(self.tails, zs))

        per: List[Dict[str, Any]] = [None] * len(self.segments)
        with torch.enable_grad():
            got, losses = mapped(torch.func.grad_and_value(
                loss_one, argnums=(0, 1) if last else 0),
                (None, 0))(subs[last], xs)
            if last:
                per[last], g_act = got
            else:
                per[last] = got
            for si in range(last - 1, -1, -1):
                with torch.no_grad():
                    g_act = tuple(cross(si, p, 1, g)
                                  for p, g in enumerate(g_act))
                seg = self._segment_one(self.segments[si][1])
                if si:
                    def vjp_one(p, xs, gs, seg=seg):
                        return torch.func.vjp(seg, p, xs)[1](gs)
                    per[si], g_act = mapped(vjp_one, (None, 0, 0))(
                        subs[si], seg_in[si], g_act)
                else:
                    def vjp_one(p, xs, gs, seg=seg):
                        return torch.func.vjp(
                            lambda q: seg(q, xs), p)[1](gs)[0]
                    per[si] = mapped(vjp_one, (None, 0, 0))(
                        subs[si], seg_in[si], g_act)
        merged: Dict[str, Any] = {}
        for d in per:
            merged.update(d)
        shape = tuple(batches[0].shape[:lead])
        grads = {n: merged[n] if n in merged else tree_map(
            lambda l: l.new_zeros(shape + tuple(l.shape[lead - 1:])),
            held[n]) for n in held}
        return losses.detach(), tree_map(torch.Tensor.detach, grads)

    def per_example_oracle(self, params, real, fake, key=None):
        """What ``per_example_value_and_grad`` must equal, as a plain loop:
        each example alone through ``run``, its crossings' stages taking
        its row of the per-crossing ``(B, N)`` draw.  A reference for the
        tests and the GPU smoke run; no training path calls it."""
        key = self._default_key(key)
        b = int(real.shape[0])
        draws: Dict[Tuple[int, int, int], torch.Tensor] = {}

        def cross(i, si, p, direction, x):
            stage, noise = self.stages[si], None
            if stage.stochastic:
                ck = (si, p, direction)
                if ck not in draws:
                    draws[ck] = keys.normal(self._key(key, si, p, direction),
                                            (b, x[0].numel()), x.device)
                noise = draws[ck][i:i + 1]
            return stage.apply_per_example(x, noise=noise)

        losses, grads = [], []
        for i in range(b):
            l, g, _ = self.run(
                params, (real[i:i + 1], fake[i:i + 1]), key,
                cross=lambda *a, i=i: cross(i, *a))
            losses.append(l)
            grads.append(g)
        return torch.stack(losses), tree_map(
            lambda *gs: torch.stack(gs), *grads)

    # ------------------------------------------------------------------
    def forward_boundaries(self, params, x, key=None,
                           upto: Optional[int] = None) -> List[torch.Tensor]:
        """The staged activations ONE forward pass ships, per boundary
        (post-codec, post-noise).  ``upto`` stops after that boundary."""
        key = self._default_key(key)
        out = []
        with torch.no_grad():
            for si, (dev, names) in enumerate(self.segments[:-1]):
                for n in names:
                    x = self.apply_layer(n, params, x)
                x = self.stages[si].apply(x, self._key(key, si, 0, 0))
                out.append(x)
                if upto is not None and si >= upto:
                    break
        return out

    def shipped_boundaries(self, params, real, fake, key=None
                           ) -> Dict[str, List[Tuple[torch.Tensor, ...]]]:
        """Every boundary tensor one local step ships (fwd activations and
        bwd activation-grads, both passes), as staged; a pipelined step's
        per-micro-batch tensors concatenated back to the full batch."""
        _, _, records = self.run_pipelined(params, (real, fake), key,
                                           collect=True)
        return records

    def boundary_shapes(self, params, x_shape: Sequence[int],
                        dtype: torch.dtype = torch.float32
                        ) -> List[Tuple[int, ...]]:
        """Activation shape at each boundary for one pass of ``x_shape``
        batches, traced on the ``meta`` device (no FLOPs)."""
        ck = (tuple(x_shape), dtype)
        if ck not in self._shape_cache:
            meta = tree_map(lambda p: torch.empty_like(p, device="meta"),
                            params)
            x = torch.empty(tuple(x_shape), dtype=dtype, device="meta")
            shapes = []
            with torch.no_grad():
                for dev, names in self.segments[:-1]:
                    for n in names:
                        x = self.apply_layer(n, meta, x)
                    shapes.append(tuple(x.shape))
            self._shape_cache[ck] = shapes
        return self._shape_cache[ck]

    def segment_costs(self) -> List[float]:
        """Compute units per device segment (portions merged exactly as
        ``plan_segments`` merges them)."""
        costs: List[float] = []
        prev: Optional[str] = None
        for p in self.plan.portions:
            if prev == p.device_id:
                costs[-1] += p.cost
            else:
                costs.append(p.cost)
                prev = p.device_id
        return costs

    def overlap_schedule(self, time_factors: Dict[str, float], *,
                         lan_latency_s: float = 0.050,
                         compute_unit_s: float = 0.010,
                         bwd_fwd_ratio: float = 2.0,
                         hop_bytes: Optional[Sequence[int]] = None,
                         lan_bandwidth_bps: float = 100e6,
                         pipeline_microbatches: Optional[int] = None):
        """The 1F1B :class:`core.pipeline.OverlapSchedule` of one batch of
        this plan (K defaults to ``pipeline_microbatches``)."""
        from repro_torch.core.pipeline import schedule_for
        k = self.pipeline_microbatches if pipeline_microbatches is None \
            else int(pipeline_microbatches)
        return schedule_for(
            self.segment_costs(), [dev for dev, _ in self.segments],
            time_factors, num_microbatches=k,
            compute_unit_s=compute_unit_s, bwd_fwd_ratio=bwd_fwd_ratio,
            lan_latency_s=lan_latency_s, hop_bytes=hop_bytes,
            lan_bandwidth_bps=lan_bandwidth_bps)

    def round_timeline(self, time_factors: Dict[str, float], *,
                       lan_latency_s: float = 0.050,
                       compute_unit_s: float = 0.010,
                       bwd_fwd_ratio: float = 2.0,
                       hop_bytes: Optional[Sequence[int]] = None,
                       lan_bandwidth_bps: float = 100e6,
                       pipeline_microbatches: Optional[int] = None
                       ) -> Tuple[List[Dict[str, Any]], float]:
        """The ordered phases of ONE local batch under this plan: forward
        segment computes and boundary hops chain down the device list, then
        the backward pass walks the chain in reverse (segment computes
        scaled ``bwd_fwd_ratio``).

        ``hop_bytes`` lists the bytes of each hop event in the flattened
        ``[b0.fwd, b0.bwd, b1.fwd, ...]`` order; given, each hop costs
        ``lan_latency_s + 8*bytes/bw``, else ``lan_latency_s``.  Returns
        ``(phases, batch_time_s)``; the durations sum to
        ``core/simulate.plan_epoch_time``'s per-batch time under the same
        arguments.  Pipelined (``K > 1``, defaulting to
        ``pipeline_microbatches``), the phases are the 1F1B schedule's
        per-micro-batch spans, which overlap across devices, and the batch
        time is its makespan (``plan_epoch_time``'s at the same K).
        """
        k = self.pipeline_microbatches if pipeline_microbatches is None \
            else int(pipeline_microbatches)
        if k > 1 and self.num_boundaries > 0:
            sched = self.overlap_schedule(
                time_factors, lan_latency_s=lan_latency_s,
                compute_unit_s=compute_unit_s, bwd_fwd_ratio=bwd_fwd_ratio,
                hop_bytes=hop_bytes, lan_bandwidth_bps=lan_bandwidth_bps,
                pipeline_microbatches=k)
            phases: List[Dict[str, Any]] = []
            for task in sched.tasks:
                if task.kind in ("fwd", "bwd"):
                    dev = task.device
                    phases.append({
                        "name": f"{task.kind} {dev} mb{task.microbatch}",
                        "cat": "segment", "track": dev,
                        "t0": task.t0, "t1": task.t1,
                        "args": {"microbatch": task.microbatch,
                                 "segment": task.index}})
                else:
                    b = self.boundaries[task.index]
                    direction = "fwd" if task.kind == "hop_fwd" else "bwd"
                    frm, to = (b.from_device, b.to_device) \
                        if direction == "fwd" \
                        else (b.to_device, b.from_device)
                    phases.append({
                        "name": f"b{b.index} {direction} {frm}->{to} "
                                f"mb{task.microbatch}",
                        "cat": "boundary", "track": frm,
                        "t0": task.t0, "t1": task.t1,
                        "args": {"boundary": b.index,
                                 "direction": direction,
                                 "microbatch": task.microbatch,
                                 "stage": self.stages[b.index].name}})
            return phases, sched.makespan
        seg_costs = self.segment_costs()
        bw = max(float(lan_bandwidth_bps), 1.0)

        def hop_time(b: int, direction: int) -> float:
            if hop_bytes is None:
                return lan_latency_s
            return lan_latency_s + 8.0 * int(hop_bytes[2 * b + direction]) / bw

        def seg_time(si: int, ratio: float) -> float:
            dev = self.segments[si][0]
            return seg_costs[si] * compute_unit_s * time_factors[dev] * ratio

        phases: List[Dict[str, Any]] = []
        t = 0.0

        def emit(name: str, cat: str, track: str, dur: float, **args):
            nonlocal t
            phases.append({"name": name, "cat": cat, "track": track,
                           "t0": t, "t1": t + dur, "args": args})
            t += dur

        for si, (dev, names) in enumerate(self.segments):
            emit(f"fwd {dev}", "segment", dev, seg_time(si, 1.0),
                 layers=len(names))
            if si < len(self.segments) - 1:
                b = self.boundaries[si]
                emit(f"b{b.index} fwd {b.from_device}->{b.to_device}",
                     "boundary", b.from_device, hop_time(si, 0),
                     boundary=b.index, direction="fwd",
                     stage=self.stages[si].name)
        for si in range(len(self.segments) - 1, -1, -1):
            dev = self.segments[si][0]
            emit(f"bwd {dev}", "segment", dev, seg_time(si, bwd_fwd_ratio))
            if si > 0:
                b = self.boundaries[si - 1]
                emit(f"b{b.index} bwd {b.to_device}->{b.from_device}",
                     "boundary", b.to_device, hop_time(si - 1, 1),
                     boundary=b.index, direction="bwd",
                     stage=self.stages[si - 1].name)
        return phases, t

    def step_wire_bytes(self, params, x_shape: Sequence[int],
                        dtype: torch.dtype = torch.float32
                        ) -> Tuple[int, List[Dict[str, int]]]:
        """Measured LAN bytes of ONE local step under this plan + stage.

        Returns ``(total, per_boundary)`` where ``per_boundary[b]`` has
        ``fwd``/``bwd`` bytes for one pass; the total counts both
        directions across all passes (the cotangent has the activation's
        shape, so fwd == bwd under every stage here).
        """
        per = []
        total = 0
        for si, shp in enumerate(self.boundary_shapes(params, x_shape,
                                                      dtype)):
            wb = self.stages[si].wire_bytes(shp, dtype)
            per.append({"fwd": wb, "bwd": wb})
            total += 2 * wb * self.num_passes
        return total, per
