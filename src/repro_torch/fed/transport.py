"""Wire model for the federation runtime: links, payloads, codecs.
Port of ``repro/fed/transport.py``; of the codecs only the identity is
ported (fp16 / int8 / top-k wait for ROADMAP Queue A item 3).

What crosses the network in the paper's protocol (§3) is small and
asymmetric:

  * **downlink** (server -> client): batches of generated fakes — the server
    never ships G itself, only its outputs (the privacy argument);
  * **uplink** (client -> server): the trained discriminator parameters.

Every transfer is priced by a :class:`LinkModel` and counted in a
:class:`TrafficLedger`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import leaves, tree_map


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
    """Per-round, per-client byte accounting: WAN uplink (D params), WAN
    downlink (fake batches) and the LAN inside each client's split chain
    (zero while clients train unsplit)."""
    up_bytes: Dict[str, int] = field(default_factory=dict)
    down_bytes: Dict[str, int] = field(default_factory=dict)
    lan_bytes: Dict[str, int] = field(default_factory=dict)

    def record(self, client_id: str, *, up: int = 0, down: int = 0,
               lan: int = 0) -> None:
        self.up_bytes[client_id] = self.up_bytes.get(client_id, 0) + int(up)
        self.down_bytes[client_id] = (self.down_bytes.get(client_id, 0)
                                      + int(down))
        if lan:
            self.lan_bytes[client_id] = (self.lan_bytes.get(client_id, 0)
                                         + int(lan))

    @property
    def total_up(self) -> int:
        return sum(self.up_bytes.values())

    @property
    def total_down(self) -> int:
        return sum(self.down_bytes.values())

    @property
    def total_lan(self) -> int:
        return sum(self.lan_bytes.values())


class Codec:
    """Round-trip over an uplink tree: ``roundtrip(tree)`` returns
    ``(decoded_tree, wire_bytes)``."""
    name = "none"

    def roundtrip(self, tree) -> Tuple[Any, int]:
        raise NotImplementedError


class IdentityCodec(Codec):
    """No compression; wire bytes = native tree bytes."""
    name = "none"

    def roundtrip(self, tree) -> Tuple[Any, int]:
        return tree, tree_bytes(tree)


def make_codec(name: str) -> Codec:
    """Factory keyed by ``config.FedConfig.codec``."""
    if name in ("none", "", "identity"):
        return IdentityCodec()
    raise NotImplementedError(
        f"fed.codec={name!r} is not ported to repro_torch yet (ROADMAP "
        f"Queue A item 3: codecs)")
