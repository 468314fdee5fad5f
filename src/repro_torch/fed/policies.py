"""Server aggregation policies.  Port of ``repro/fed/policies.py``.

  SyncFedAvg   the paper's rule: barrier on all surviving clients, weighted
               average (host ``core/fedavg``, or the fedavg CUDA kernel
               with ``use_kernel``).
  FedAsync     Xie et al.: apply every update the moment it arrives,
               down-weighted by staleness
                   global <- (1 - a_t) * global + a_t * params,
                   a_t = alpha * (1 + staleness) ** -staleness_power.
  FedBuff      Nguyen et al.: buffer K updates (staleness-discounted
               weights), aggregate the buffer, mix with server_lr.

The engine calls ``on_update`` for every arriving update (in virtual-time
order) and ``on_round_end`` once per round; a policy returns the possibly
updated global tree plus whether it advanced the global model version
(which is what staleness counts).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

from repro_torch.core.fedavg import fedavg
from repro_torch.kernels.agg_fuse.ref import f32
from repro_torch.kernels.fedavg.ops import fedavg_trees
from repro_torch.tree import tree_map


@dataclass
class ClientUpdate:
    client_id: str
    params: Any                 # decoded (post-codec) discriminator tree
    weight: float               # FedAvg weight (client example count)
    staleness: int = 0          # global versions advanced since download
    recv_time: float = 0.0      # virtual arrival time at the server


def _mix(global_tree, update_tree, rate: float):
    """fp32 convex blend ``(1 - r) * global + r * update`` with r and 1 - r
    rounded to fp32 as the reference's ``jnp.float32`` arithmetic does,
    cast back to the global tree's dtypes."""
    r = f32(rate)
    keep = f32(1.0 - r)
    return tree_map(
        lambda g, u: (keep * g.to(torch.float32)
                      + r * u.to(torch.float32)).to(g.dtype),
        global_tree, update_tree)


class AggregationPolicy:
    """Base: buffer everything, do nothing until told."""
    name = "base"

    def on_update(self, global_tree, up: ClientUpdate) -> Tuple[Any, bool]:
        return global_tree, False

    def on_round_end(self, global_tree) -> Any:
        return global_tree

    def reset(self) -> None:
        pass


class SyncFedAvg(AggregationPolicy):
    """Barrier aggregation — the sequential trainer's exact rule.

    Updates are buffered in arrival order (== participation order under the
    sync engine), and the round-end average calls the same host ``fedavg``
    with the same ordering and weights as the sequential loop, so the
    no-dropout sync path is bit-for-bit identical.  ``use_kernel`` sends
    the aggregation through the fedavg CUDA kernel instead
    (``kernels/fedavg``).
    """
    name = "sync"

    def __init__(self, weighted: bool = True, use_kernel: bool = False):
        self.weighted = weighted
        self.use_kernel = use_kernel
        self._buffer: List[ClientUpdate] = []

    def on_update(self, global_tree, up: ClientUpdate) -> Tuple[Any, bool]:
        self._buffer.append(up)
        return global_tree, False

    def on_round_end(self, global_tree) -> Any:
        if not self._buffer:
            return global_tree
        trees = [u.params for u in self._buffer]
        weights = ([u.weight for u in self._buffer] if self.weighted
                   else None)
        self._buffer = []
        if self.use_kernel:
            return fedavg_trees(trees, weights)
        return fedavg(trees, weights)


class FedAsync(AggregationPolicy):
    """Staleness-weighted immediate application (FedAsync)."""
    name = "fedasync"

    def __init__(self, alpha: float = 0.6, staleness_power: float = 0.5):
        self.alpha = float(alpha)
        self.staleness_power = float(staleness_power)

    def rate(self, staleness: int) -> float:
        return self.alpha * (1.0 + staleness) ** (-self.staleness_power)

    def on_update(self, global_tree, up: ClientUpdate) -> Tuple[Any, bool]:
        return _mix(global_tree, up.params, self.rate(up.staleness)), True


class FedBuff(AggregationPolicy):
    """Buffered async aggregation: fire once K updates are waiting.

    Buffered updates are weighted by ``weight * (1+staleness)^-power`` and
    averaged (host FedAvg, as in the reference); the server blends the
    buffer mean in at ``server_lr`` (1.0 == replace, the FedBuff default).
    A non-empty buffer at round end is flushed, so no client work is
    silently dropped.
    """
    name = "fedbuff"

    def __init__(self, buffer_size: int = 2, server_lr: float = 1.0,
                 staleness_power: float = 0.5):
        self.buffer_size = max(1, int(buffer_size))
        self.server_lr = float(server_lr)
        self.staleness_power = float(staleness_power)
        self._buffer: List[ClientUpdate] = []

    def _flush(self, global_tree):
        ws = [u.weight * (1.0 + u.staleness) ** (-self.staleness_power)
              for u in self._buffer]
        mean = fedavg([u.params for u in self._buffer], ws)
        self._buffer = []
        return _mix(global_tree, mean, self.server_lr)

    def on_update(self, global_tree, up: ClientUpdate) -> Tuple[Any, bool]:
        self._buffer.append(up)
        if len(self._buffer) >= self.buffer_size:
            return self._flush(global_tree), True
        return global_tree, False

    def on_round_end(self, global_tree) -> Any:
        if self._buffer:
            return self._flush(global_tree)
        return global_tree

    def reset(self) -> None:
        self._buffer = []


def make_policy(fed_cfg, *, weighted: bool = True) -> AggregationPolicy:
    """Factory keyed by ``config.FedConfig.mode``."""
    if fed_cfg.mode == "sync":
        return SyncFedAvg(weighted, fed_cfg.kernel_aggregation)
    if fed_cfg.mode == "fedasync":
        return FedAsync(fed_cfg.fedasync_alpha, fed_cfg.staleness_power)
    if fed_cfg.mode == "fedbuff":
        return FedBuff(fed_cfg.buffer_size,
                       staleness_power=fed_cfg.staleness_power)
    raise ValueError(f"unknown fed mode {fed_cfg.mode!r}")
