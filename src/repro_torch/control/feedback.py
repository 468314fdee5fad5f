"""Typed per-round feedback and knob records — the control plane's wire.
Port of ``repro/control/feedback.py`` (pure Python, copied).

Every layer of the engine already *measures*: the :class:`~repro_torch.fed.
transport.TrafficLedger` counts WAN/LAN bytes, the engine prices per-client
virtual finish times and the codec's delta error, the accountant tracks the
(epsilon, delta) spend, the split execution measures per-device load and the
privacy subsystem's dCor probes measure per-boundary leakage.  This module
gives all of that ONE typed record per round — :class:`RoundFeedback` —
instead of ad-hoc trainer metric dicts, and one typed record for the knobs a
controller may turn — :class:`ControlKnobs`.

The contract: controllers are pure functions
``(history: list[RoundFeedback], knobs: ControlKnobs) -> ControlKnobs``
(see controllers.py).  The trainer assembles a ``RoundFeedback`` after every
round (``control.mode='frozen'`` included — measurement is free; only knob
*application* is gated) and applies knob diffs before the next one.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Mapping, Optional, Tuple


@dataclass(frozen=True)
class ControlKnobs:
    """Everything a controller may turn between rounds.

    Seeded from the static config (:func:`knobs_from_config`); the frozen
    mode never changes it, so the static path stays bit-exact.
    """
    codec: str = "none"                # uplink codec (fed/transport)
    topk_frac: float = 0.01
    sigma: float = 0.0                 # DP noise multiplier (both modes)
    deadline_s: float = 0.0            # sync straggler deadline (0 = off)
    split_strategy: str = "sorted_multi"   # core/selection replanning
    # per-boundary stage override: boundary index -> stage name; None keeps
    # the uniform cfg.split.boundary_stage.  Plans with more boundaries
    # than the map fall back to the config stage at the unlisted indices.
    stage_by_boundary: Optional[Mapping[int, str]] = None

    def replace(self, **kw) -> "ControlKnobs":
        return replace(self, **kw)


@dataclass(frozen=True)
class RoundFeedback:
    """One round's measurements, as the controllers consume them.

    Which controller reads what:

      * codec controller    — ``codec``/``up_bytes``/``codec_error``
                              (the bytes-vs-delta-error frontier) +
                              ``uplink_bps`` (measured bandwidth);
      * sigma controller    — ``sigma``/``dp_steps``/``dp_epsilon``
                              (replays the accountant's spend);
      * split controller    — ``device_loads`` (imbalance drift) +
                              ``boundary_dcor`` (leakage drift);
      * deadline controller — ``client_finish_s`` (the measured round-time
                              distribution) + ``stragglers``.
    """
    round_index: int
    backend: str
    # knobs in force during this round
    codec: str
    sigma: float
    deadline_s: float
    split_strategy: str
    # measured wire (TrafficLedger, this round)
    up_bytes: int
    down_bytes: int
    lan_bytes: int
    codec_error: float                 # mean rel-L2 delta error (nan: none ran)
    uplink_bps: float
    # measured time (virtual clock)
    round_time_s: float
    clock_s: float
    client_finish_s: Mapping[str, float] = field(default_factory=dict)
    # participation
    num_clients: int = 0
    stragglers: int = 0
    # training + privacy
    d_loss: float = float("nan")
    g_loss: float = float("nan")
    dp_epsilon: float = float("nan")   # cumulative spend after this round
    dp_steps: int = 0                  # mechanism releases this round
    # split measurements.  boundary_dcor is the RAW (pre-stage) smashed
    # activation's dCor — the boundary's intrinsic leak, a stable control
    # signal regardless of what stage currently protects it (post-stage
    # leakage is the attack suite's measurement, not the controller's).
    device_loads: Mapping[str, float] = field(default_factory=dict)
    boundary_dcor: Mapping[str, Tuple[float, ...]] = field(
        default_factory=dict)          # per split client, per boundary idx
    # pipelined split execution (core/pipeline): micro-batches per batch
    # in force this round, and the mean analytic sequential/pipelined
    # per-batch ratio across split clients (1.0 when not pipelined).
    # The deadline controller rescales historical finish times by this
    # ratio when K changes between rounds.
    pipeline_microbatches: int = 1
    pipeline_speedup: float = 1.0
    # backend="auto": dispatch probe wall-times (µs per backend) from
    # the round that ran the probe; empty otherwise
    backend_probe_us: Mapping[str, float] = field(default_factory=dict)
    # population-scale topology in force this round: client->edge bytes
    # (the pre-reduce hop; 0 on the flat path), edge cohorts (0/1 = flat
    # single-tier), and `clients`-mesh shards the vectorized dispatch
    # placed stacked inputs across (1 = single-device).
    edge_bytes: int = 0
    cohorts: int = 0
    shards: int = 1

    def summary(self) -> Dict[str, object]:
        """Compact printable view (the demos use this as schema docs)."""
        return {
            "round": self.round_index,
            "codec": self.codec,
            "sigma": self.sigma,
            "deadline_s": round(self.deadline_s, 3),
            "split_strategy": self.split_strategy,
            "up_bytes": self.up_bytes,
            "lan_bytes": self.lan_bytes,
            "edge_bytes": self.edge_bytes,
            "codec_error": self.codec_error,
            "round_time_s": round(self.round_time_s, 3),
            "num_clients": self.num_clients,
            "stragglers": self.stragglers,
            "dp_epsilon": self.dp_epsilon,
            "device_loads": dict(self.device_loads),
            "boundary_dcor": {k: tuple(round(v, 3) for v in vs)
                              for k, vs in self.boundary_dcor.items()},
        }


def knobs_from_config(cfg) -> ControlKnobs:
    """The static config as the initial knob state (frozen mode keeps it)."""
    return ControlKnobs(
        codec=cfg.fed.codec,
        topk_frac=cfg.fed.topk_frac,
        sigma=cfg.privacy.noise_multiplier,
        deadline_s=cfg.fed.deadline_s,
        split_strategy=cfg.split.strategy or cfg.fsl.selection,
        stage_by_boundary=None)
