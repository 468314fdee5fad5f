"""Wire model for the federation runtime: links, payloads, codecs.
Port of ``repro/fed/transport.py``.

What crosses the network in the paper's protocol (§3) is small and
asymmetric:

  * **downlink** (server -> client): batches of generated fakes — the server
    never ships G itself, only its outputs (the privacy argument);
  * **uplink** (client -> server): the trained discriminator parameters
    (or parameter *deltas* when a lossy codec is enabled).

Every transfer is priced by a :class:`LinkModel` and counted in a
:class:`TrafficLedger`; uplink trees can be run through compression codecs
(fp16 / int8 quantize-dequantize / top-k sparsification with error
feedback).  LAN hops inside one client's split chain are a third budget
(the ledger's ``lan`` column, measured by ``core/split.SplitExecution``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like


def tree_bytes(tree) -> int:
    """Total payload bytes of a tree at its native dtypes."""
    return int(sum(l.numel() * l.element_size() for l in leaves(tree)))


def delta_tree(params, base):
    """The uplinked update delta ``params - base``, leafwise in fp32."""
    return tree_map(lambda p, b: p.to(torch.float32) - b.to(torch.float32),
                    params, base)


def apply_delta(base, delta):
    """Rebase an fp32 delta onto ``base``, cast back to the base dtypes —
    inverse of :func:`delta_tree`."""
    return tree_map(
        lambda b, d: (b.to(torch.float32) + d.to(torch.float32)).to(b.dtype),
        base, delta)


def tree_rel_error(approx, exact) -> float:
    """Relative global-L2 error of ``approx`` vs ``exact``, summed in
    float64 — what a lossy codec cost the update."""
    num = 0.0
    den = 0.0
    for a, e in zip(leaves(approx), leaves(exact)):
        e64 = e.to(torch.float64)
        d = a.to(torch.float64) - e64
        num += float(torch.sum(d * d))
        den += float(torch.sum(e64 * e64))
    return math.sqrt(num) / max(math.sqrt(den), 1e-12)


def predict_codec_bytes(name: str, leaf_sizes: Sequence[int], *,
                        dtype_bytes: int = 4, topk_frac: float = 0.01) -> int:
    """Analytic wire bytes of one uplink round-trip per codec, from the
    tree's leaf sizes alone."""
    if name in ("none", "", "identity"):
        return int(sum(leaf_sizes) * dtype_bytes)
    if name == "fp16":
        return int(sum(leaf_sizes) * 2)
    if name == "int8":
        return int(sum(n + 4 for n in leaf_sizes))
    if name == "topk":
        return int(sum(8 * _topk_k(n, topk_frac) for n in leaf_sizes))
    raise ValueError(f"unknown codec {name!r}")


def fake_batch_bytes(batch: int, image_shape: Tuple[int, ...],
                     dtype_bytes: int = 4) -> int:
    """Downlink bytes for one batch of generated fakes."""
    n = batch
    for s in image_shape:
        n *= s
    return int(n * dtype_bytes)


@dataclass(frozen=True)
class LinkModel:
    """One-way link: fixed latency plus serialization at ``bandwidth_bps``."""
    latency_s: float = 0.050
    bandwidth_bps: float = 10e6

    def transfer_time(self, nbytes: int) -> float:
        return self.latency_s + 8.0 * nbytes / max(self.bandwidth_bps, 1.0)


@dataclass
class TrafficLedger:
    """Per-round, per-client byte accounting: WAN uplink (D params or
    deltas; under the edge hierarchy keyed ``cohort<k>``, since only the
    cohorts' pre-reduced aggregates cross the WAN), WAN downlink (fake
    batches), the LAN inside each client's split chain (zero while clients
    train unsplit) and the client->edge hop before a cohort's pre-reduce
    (empty on the flat path)."""
    up_bytes: Dict[str, int] = field(default_factory=dict)
    down_bytes: Dict[str, int] = field(default_factory=dict)
    lan_bytes: Dict[str, int] = field(default_factory=dict)
    edge_bytes: Dict[str, int] = field(default_factory=dict)

    def record(self, client_id: str, *, up: int = 0, down: int = 0,
               lan: int = 0) -> None:
        self.up_bytes[client_id] = self.up_bytes.get(client_id, 0) + int(up)
        self.down_bytes[client_id] = (self.down_bytes.get(client_id, 0)
                                      + int(down))
        if lan:
            self.lan_bytes[client_id] = (self.lan_bytes.get(client_id, 0)
                                         + int(lan))

    def record_edge(self, client_id: str, nbytes: int) -> None:
        """Client->edge uplink bytes (the pre-reduce hop)."""
        self.edge_bytes[client_id] = (self.edge_bytes.get(client_id, 0)
                                      + int(nbytes))

    @property
    def total_up(self) -> int:
        return sum(self.up_bytes.values())

    @property
    def total_down(self) -> int:
        return sum(self.down_bytes.values())

    @property
    def total_lan(self) -> int:
        return sum(self.lan_bytes.values())

    @property
    def total_edge(self) -> int:
        return sum(self.edge_bytes.values())


# ---------------------------------------------------------------------------
# Codecs — quantize-dequantize transforms over uplink parameter trees
# ---------------------------------------------------------------------------

class Codec:
    """Lossy round-trip over an uplink tree.

    ``encodes_delta``: whether the engine feeds the codec the update delta
    ``params - global`` (every lossy codec) or the raw parameters
    (identity).  ``roundtrip(tree)`` returns ``(decoded_tree, wire_bytes)``.
    Stateful codecs (top-k with error feedback) carry a residual across
    calls, so the engine keeps one codec instance per client.

    ``encode(x)`` / ``decode(wire, meta, dtype)`` are the per-tensor wire
    form: ``decode(*encode(x), x.dtype)`` equals ``roundtrip(x)[0]`` for
    every stateless codec.  ``encode_tree`` is the whole-tree wire form
    (per-leaf ``(wire, meta)`` in :func:`leaves` order) with the same wire
    bytes ``roundtrip`` reports.
    """
    name = "none"
    encodes_delta = False

    def roundtrip(self, tree) -> Tuple[Any, int]:
        raise NotImplementedError

    def encode(self, x: torch.Tensor) -> Tuple[Any, Any]:
        return x, None

    def decode(self, wire, meta, dtype=torch.float32) -> torch.Tensor:
        del meta
        return wire.to(dtype)

    def encode_tree(self, tree) -> Tuple[List[Tuple[Any, Any]], int]:
        return [(l, None) for l in leaves(tree)], tree_bytes(tree)


class IdentityCodec(Codec):
    """No compression; wire bytes = native tree bytes."""
    name = "none"
    encodes_delta = False

    def roundtrip(self, tree) -> Tuple[Any, int]:
        return tree, tree_bytes(tree)


class FP16Codec(Codec):
    """Cast leaves to fp16 on the wire, back to native dtype on arrival."""
    name = "fp16"
    encodes_delta = True

    def roundtrip(self, tree) -> Tuple[Any, int]:
        dec = tree_map(lambda l: l.to(torch.float16).to(l.dtype), tree)
        return dec, int(sum(l.numel() * 2 for l in leaves(tree)))

    def encode(self, x: torch.Tensor) -> Tuple[Any, Any]:
        return x.to(torch.float16), None

    def encode_tree(self, tree) -> Tuple[List[Tuple[Any, Any]], int]:
        ls = leaves(tree)
        return ([(l.to(torch.float16), None) for l in ls],
                int(sum(l.numel() * 2 for l in ls)))


def int8_scale(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 scale of fp32 ``x``: amax / 127, or 1.0 for an
    all-zero tensor (any positive scale maps q = 0 back to zeros; 1.0
    avoids a subnormal division)."""
    return int8_scale_of(torch.max(torch.abs(x)))


def int8_scale_of(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` where ``amax > 0``, else 1.0 (a NaN amax gives 1.0),
    elementwise.  The divisor is a tensor on ``amax``'s device: PyTorch's
    CUDA division by a Python number multiplies by its rounded reciprocal,
    one ulp off the IEEE quotient for about 5% of values, and the codec's
    scale is the reference's true quotient on every device."""
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                       torch.ones_like(amax))


def int8_round(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` in fp32: IEEE division,
    round half to even."""
    return torch.clamp(torch.round(x / scale), -127, 127)


class Int8Codec(Codec):
    """Per-leaf symmetric int8 quantization: q = round(x / s), s = amax/127.

    Wire cost: 1 byte per element + one fp32 scale per leaf.
    """
    name = "int8"
    encodes_delta = True

    def roundtrip(self, tree) -> Tuple[Any, int]:
        def qdq(l):
            x = l.to(torch.float32)
            scale = int8_scale(x)
            return (int8_round(x, scale) * scale).to(l.dtype)

        return tree_map(qdq, tree), int(sum(l.numel() + 4
                                             for l in leaves(tree)))

    def encode(self, x: torch.Tensor) -> Tuple[Any, Any]:
        f = x.to(torch.float32)
        scale = int8_scale(f)
        return int8_round(f, scale).to(torch.int8), scale

    def decode(self, wire, meta, dtype=torch.float32) -> torch.Tensor:
        return (wire.to(torch.float32) * meta).to(dtype)

    def encode_tree(self, tree) -> Tuple[List[Tuple[Any, Any]], int]:
        ls = leaves(tree)
        return ([self.encode(l) for l in ls],
                int(sum(l.numel() + 4 for l in ls)))


def _topk_k(n: int, frac: float) -> int:
    """Entries top-k keeps of an n-element leaf, clamped into [1, n]."""
    return min(n, max(1, int(math.ceil(frac * n))))


class TopKCodec(Codec):
    """Magnitude top-k sparsification with error feedback (Stich et al.).

    Keeps the ``frac`` largest-|x| entries per leaf; the dropped mass is
    carried in a residual and added back before the next round's selection.
    Wire cost: 8 bytes per kept entry (fp32 value + int32 index).  Among
    equal magnitudes ``torch.topk`` may keep other entries than
    ``jax.lax.top_k``.
    """
    name = "topk"
    encodes_delta = True

    def __init__(self, frac: float = 0.01, error_feedback: bool = True):
        self.frac = float(frac)
        self.error_feedback = bool(error_feedback)
        self._residual: Optional[Any] = None

    def _with_residual(self, tree):
        if self.error_feedback and self._residual is not None:
            return tree_map(lambda l, r: l + r.to(l.dtype), tree,
                            self._residual)
        return tree

    def _select(self, flat: torch.Tensor) -> torch.Tensor:
        k = _topk_k(flat.numel(), self.frac)
        return torch.topk(torch.abs(flat), k).indices

    def roundtrip(self, tree) -> Tuple[Any, int]:
        tree = self._with_residual(tree)
        kept = 0

        def sparsify(l):
            nonlocal kept
            flat = l.to(torch.float32).reshape(-1)
            idx = self._select(flat)
            kept += idx.numel()
            mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
            return (flat * mask).reshape(l.shape).to(l.dtype)

        dec = tree_map(sparsify, tree)
        if self.error_feedback:
            self._residual = tree_map(
                lambda l, d: l.to(torch.float32) - d.to(torch.float32),
                tree, dec)
        return dec, int(kept * 8)

    def encode(self, x: torch.Tensor) -> Tuple[Any, Any]:
        """Stateless per-tensor encode: the kept values + their flat
        indices."""
        flat = x.to(torch.float32).reshape(-1)
        idx = self._select(flat)
        return (flat[idx], idx.to(torch.int32)), tuple(x.shape)

    def decode(self, wire, meta, dtype=torch.float32) -> torch.Tensor:
        vals, idx = wire
        n = math.prod(int(s) for s in meta)
        out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
        out[idx.long()] = vals
        return out.reshape(meta).to(dtype)

    def encode_tree(self, tree) -> Tuple[List[Tuple[Any, Any]], int]:
        """Stateful whole-tree encode: adds the carried residual before
        selection and advances it, as ``roundtrip`` does."""
        tree = self._with_residual(tree)
        enc: List[Tuple[Any, Any]] = []
        res_leaves = []
        kept = 0
        for l in leaves(tree):
            flat = l.to(torch.float32).reshape(-1)
            idx = self._select(flat)
            kept += idx.numel()
            enc.append(((flat[idx], idx.to(torch.int32)), tuple(l.shape)))
            res_leaves.append(flat.index_fill(0, idx, 0.0).reshape(l.shape))
        if self.error_feedback:
            self._residual = unflatten_like(tree, res_leaves)
        return enc, int(kept * 8)


def make_codec(name: str, *, topk_frac: float = 0.01,
               error_feedback: bool = True) -> Codec:
    """Factory keyed by ``config.FedConfig.codec``."""
    if name in ("none", "", "identity"):
        return IdentityCodec()
    if name == "fp16":
        return FP16Codec()
    if name == "int8":
        return Int8Codec()
    if name == "topk":
        return TopKCodec(topk_frac, error_feedback)
    raise ValueError(f"unknown codec {name!r}")
