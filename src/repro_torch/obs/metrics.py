"""Typed metric registry + JSONL sink for the federated split engine.
Port of ``repro/obs/metrics.py`` (pure Python, copied).

Three instrument kinds, mirroring the usual telemetry taxonomy:

  * :class:`Counter`   — monotone totals (wire bytes, straggler drops).
  * :class:`Gauge`     — last-value-wins per-round readings (codec error,
    per-boundary dCor, epsilon spend, losses).
  * :class:`Histogram` — distributions (client finish times): fixed
    log-spaced buckets plus exact count/sum/min/max.

:func:`observe_round` is the single choke point that turns one
``RoundFeedback`` into registry updates — `RoundFeedback` assembly feeds
this instead of each caller hand-rolling ad-hoc dicts.  The
:class:`JsonlSink` appends one snapshot object per round so a run's
metric history is greppable/plottable without rerunning anything.
"""
from __future__ import annotations

import json
import math
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

METRIC_KINDS = ("counter", "gauge", "histogram")


@dataclass
class Counter:
    name: str
    help: str = ""
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        self.value += amount

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": "counter", "value": self.value}


@dataclass
class Gauge:
    name: str
    help: str = ""
    value: float = math.nan

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": "gauge", "value": self.value}


def _log_buckets(lo: float = 1e-3, hi: float = 1e3,
                 per_decade: int = 2) -> Tuple[float, ...]:
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


@dataclass
class Histogram:
    """Fixed-bucket histogram (upper bounds, +inf implicit) with exact
    count/sum/min/max so means survive coarse buckets."""
    name: str
    help: str = ""
    bounds: Tuple[float, ...] = field(default_factory=_log_buckets)
    counts: List[int] = field(default_factory=list)
    count: int = 0
    sum: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    def __post_init__(self) -> None:
        if not self.counts:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect_right(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the covering bucket)."""
        if not self.count:
            return math.nan
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": "histogram", "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "bounds": list(self.bounds), "counts": list(self.counts)}


class MetricsRegistry:
    """Get-or-create registry; re-registering with a different kind is an
    error (one name, one instrument, one meaning for the whole run)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name=name, help=help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  bounds: Optional[Tuple[float, ...]] = None) -> Histogram:
        kw = {"bounds": bounds} if bounds is not None else {}
        return self._get(Histogram, name, help, **kw)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {n: self._metrics[n].snapshot() for n in self.names()}

    def render(self, *, prefix: str = "") -> str:
        """Human-readable dump for demos — one metric per line."""
        lines = []
        for n in self.names():
            if prefix and not n.startswith(prefix):
                continue
            m = self._metrics[n]
            if isinstance(m, Histogram):
                lines.append(
                    f"{n:<42s} hist  n={m.count} mean={m.mean:.4g} "
                    f"min={m.min:.4g} max={m.max:.4g} p90~{m.quantile(0.9):.4g}")
            elif isinstance(m, Counter):
                lines.append(f"{n:<42s} count {m.value:.6g}")
            else:
                lines.append(f"{n:<42s} gauge {m.value:.6g}")
        return "\n".join(lines)


class JsonlSink:
    """Append-only JSONL writer: one JSON object per line, flushed eagerly
    so a killed run still leaves a readable log."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def write(self, obj: Mapping[str, Any]) -> None:
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def observe_round(registry: MetricsRegistry, fb) -> None:
    """Feed one ``RoundFeedback`` into the registry — the single choke
    point that replaces the old ad-hoc per-demo field printing."""
    registry.counter("fed.rounds", "rounds completed").inc()
    registry.counter("wire.up_bytes", "uplinked bytes, cumulative") \
        .inc(fb.up_bytes)
    registry.counter("wire.down_bytes", "downlinked bytes, cumulative") \
        .inc(fb.down_bytes)
    registry.counter("wire.lan_bytes", "intra-client LAN bytes, cumulative") \
        .inc(fb.lan_bytes)
    registry.counter("fed.straggler_drops", "clients past deadline, "
                     "cumulative").inc(fb.stragglers)
    registry.gauge("fed.round_time_s", "latest round makespan") \
        .set(fb.round_time_s)
    registry.gauge("fed.clock_s", "virtual clock after latest round") \
        .set(fb.clock_s)
    registry.gauge("codec.rel_error", "latest uplink codec relative error") \
        .set(fb.codec_error)
    registry.gauge("gan.d_loss", "latest discriminator loss").set(fb.d_loss)
    registry.gauge("gan.g_loss", "latest generator loss").set(fb.g_loss)
    registry.gauge("privacy.epsilon", "cumulative epsilon spend") \
        .set(fb.dp_epsilon)
    finish = registry.histogram("fed.client_finish_s",
                                "per-client finish times, all rounds")
    for t in fb.client_finish_s.values():
        if math.isfinite(t):
            finish.observe(t)
    # boundary_dcor: client id -> (dcor at boundary 0, 1, ...)
    for cid, dcors in sorted(fb.boundary_dcor.items()):
        for b, d in enumerate(dcors):
            registry.gauge(
                f"privacy.dcor.{cid}.b{b}",
                f"latest raw-activation dCor, client {cid} boundary {b}") \
                .set(d)
