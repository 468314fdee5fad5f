"""The flight recorder: one run directory holding everything the engine
measured — enough to replay the run's control decisions offline.  Port of
``repro/obs/recorder.py`` (pure Python, copied).

Layout of one run directory (``<cfg.obs.out_dir>/<run_id>/``):

  * ``manifest.json``   — the full RunConfig plus the controller inputs
    (``leaf_sizes``, ``steps_per_round_hint``) that ``control.
    make_controllers`` needs to rebuild the exact live suite;
  * ``feedback.jsonl``  — one serialized :class:`RoundFeedback` per round,
    appended eagerly (a killed run still leaves a readable log);
  * ``knobs.jsonl``     — the :class:`ControlKnobs` in force during each
    round (the controller's decision sequence — what replay must
    reproduce bit-exactly);
  * ``metrics.jsonl``   — one metric-registry snapshot per round;
  * ``trace.json``      — the Chrome-trace export, written at ``flush()``:
    the engine's virtual-clock spans and, with ``trace_clock`` ``wall`` or
    ``both``, the program's host spans (``obs/trace.py``) with absolute
    system-clock timestamps and host-sync counts, to lay beside a
    ``torch.profiler`` trace of the same run;
  * ``alerts.jsonl``    — typed :class:`~repro_torch.obs.health.HealthAlert`
    records, one per tripped health check;
  * ``digests.jsonl``   — one :class:`~repro_torch.obs.digest.RoundDigest` per
    round: the committed global state, content-addressed, which is what
    lets ``repro_torch.obs.diff`` check bit-exactness claims across runs from
    artifacts alone.

Serialization is plain JSON via Python's repr-based float formatting,
which round-trips every finite float bit-exactly — the foundation of the
replay pin (``repro_torch.obs.replay``).  NaN fields (a round with no codec
error, no DP) serialize as JSON ``NaN`` tokens, which Python's loader
accepts; the logs are an internal format, read back by :func:`load_run`.
"""
from __future__ import annotations

import json
import os
from contextlib import nullcontext
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.control.feedback import ControlKnobs, RoundFeedback
from repro_torch.obs.digest import RoundDigest, digest_from_dict, digest_to_dict
from repro_torch.obs.health import HealthAlert, alert_from_dict, alert_to_dict
from repro_torch.obs.metrics import (JsonlSink, MetricsRegistry, load_jsonl,
                               observe_round)
from repro_torch.obs.trace import Tracer, tracing

MANIFEST = "manifest.json"
FEEDBACK = "feedback.jsonl"
KNOBS = "knobs.jsonl"
METRICS = "metrics.jsonl"
TRACE = "trace.json"
PROFILE = "profile.json"
ALERTS = "alerts.jsonl"
DIGESTS = "digests.jsonl"


# ---------------------------------------------------------------------------
# serde — RoundFeedback / ControlKnobs <-> JSON objects
# ---------------------------------------------------------------------------

def feedback_to_dict(fb: RoundFeedback) -> Dict[str, Any]:
    return asdict(fb)


def feedback_from_dict(d: Dict[str, Any]) -> RoundFeedback:
    d = dict(d)
    # JSON lists -> the tuples the dataclass held
    d["boundary_dcor"] = {k: tuple(v)
                          for k, v in d.get("boundary_dcor", {}).items()}
    return RoundFeedback(**d)


def knobs_to_dict(k: ControlKnobs) -> Dict[str, Any]:
    d = asdict(k)
    if k.stage_by_boundary is not None:
        d["stage_by_boundary"] = dict(k.stage_by_boundary)
    return d


def knobs_from_dict(d: Dict[str, Any]) -> ControlKnobs:
    d = dict(d)
    sbb = d.get("stage_by_boundary")
    if sbb is not None:
        # JSON object keys are strings; the live map is keyed by boundary
        # index — restore ints or the replay comparison would never match
        d["stage_by_boundary"] = {int(b): s for b, s in sbb.items()}
    return ControlKnobs(**d)


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Owns the run directory, the tracer, and the metric registry.

    ``sinks`` selects what gets persisted (``trace`` / ``metrics`` /
    ``feedback`` / ``alerts`` / ``digests``); the in-memory tracer and
    registry always run so demos can render from them even without
    persistence.
    """

    def __init__(self, run_dir: str, *, run_id: Optional[str] = None,
                 sinks=("trace", "metrics", "feedback", "alerts", "digests"),
                 trace_clock: str = "virtual", trace_batches: int = 0):
        self.run_dir = run_dir
        self.run_id = run_id or os.path.basename(run_dir)
        self.sinks = tuple(sinks)
        self.trace_clock = trace_clock
        self.trace_batches = int(trace_batches)
        os.makedirs(run_dir, exist_ok=True)
        self.tracer = Tracer(self.run_id)
        self.registry = MetricsRegistry()
        self.feedback: List[RoundFeedback] = []
        self.knob_log: List[ControlKnobs] = []
        self.alerts: List[HealthAlert] = []
        self.digests: List[RoundDigest] = []
        self._fb_sink = (JsonlSink(self.path(FEEDBACK))
                         if "feedback" in self.sinks else None)
        self._knob_sink = (JsonlSink(self.path(KNOBS))
                           if "feedback" in self.sinks else None)
        self._metric_sink = (JsonlSink(self.path(METRICS))
                             if "metrics" in self.sinks else None)
        self._alert_sink = (JsonlSink(self.path(ALERTS))
                            if "alerts" in self.sinks else None)
        self._digest_sink = (JsonlSink(self.path(DIGESTS))
                             if "digests" in self.sinks else None)
        # flush() idempotence: count of spans already exported, so a
        # second flush with no new spans is a no-op (see flush docstring)
        self._flushed_spans = 0
        self._trace_path: Optional[str] = None

    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg, *, run_id: Optional[str] = None
                    ) -> "FlightRecorder":
        """Build from ``cfg.obs`` (a full RunConfig).  ``run_id`` defaults
        to ``cfg.obs.run_id`` or, failing that, a name derived from the
        model + pid (unique enough for side-by-side local runs)."""
        obs = cfg.obs
        rid = run_id or obs.run_id \
            or f"{cfg.model.name or 'run'}-{os.getpid()}"
        return cls(os.path.join(obs.out_dir, rid), run_id=rid,
                   sinks=obs.sinks, trace_clock=obs.trace_clock,
                   trace_batches=obs.trace_batches)

    def path(self, name: str) -> str:
        return os.path.join(self.run_dir, name)

    def wants(self, sink: str) -> bool:
        return sink in self.sinks

    def tracing(self):
        """The program's host spans, with the host-device syncs made in
        each on the card, recorded into this recorder's tracer while the
        block runs (``obs/trace.tracing``), when the trace sink is on and
        ``trace_clock`` is ``wall`` or ``both``; otherwise a no-op."""
        if "trace" not in self.sinks or self.trace_clock == "virtual":
            return nullcontext()
        return tracing(self.tracer, count_syncs=True)

    # ------------------------------------------------------------------
    def set_manifest(self, cfg, *, leaf_sizes, steps_per_round_hint: int,
                     extra: Optional[Dict[str, Any]] = None) -> None:
        """Persist the config + controller inputs: everything
        ``replay_run`` needs to rebuild the live controller suite."""
        manifest = {"run_id": self.run_id,
                    "config": cfg.to_dict(),
                    "leaf_sizes": [int(s) for s in leaf_sizes],
                    "steps_per_round_hint": int(steps_per_round_hint)}
        if extra:
            manifest.update(extra)
        with open(self.path(MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2, default=str)

    def on_round(self, fb: RoundFeedback, knobs: ControlKnobs) -> None:
        """Record one completed round: the feedback the engine measured and
        the knobs that were in force while it ran."""
        self.feedback.append(fb)
        self.knob_log.append(knobs)
        observe_round(self.registry, fb)
        if self._fb_sink is not None:
            self._fb_sink.write(feedback_to_dict(fb))
        if self._knob_sink is not None:
            self._knob_sink.write(knobs_to_dict(knobs))
        if self._metric_sink is not None:
            self._metric_sink.write({"round": fb.round_index,
                                     "metrics": self.registry.snapshot()})

    def on_alert(self, alert: HealthAlert) -> None:
        """Record one tripped health check (``repro_torch.obs.health``) to the
        ``alerts.jsonl`` sink and the metrics registry."""
        self.alerts.append(alert)
        self.registry.counter(
            "health_alerts", help="health alerts, all checks").inc()
        self.registry.counter(
            f"health_alerts_{alert.check}",
            help=f"health alerts from the {alert.check} check").inc()
        if self._alert_sink is not None:
            self._alert_sink.write(alert_to_dict(alert))

    def on_digest(self, digest: RoundDigest) -> None:
        """Record one round's committed-state content digest
        (``repro_torch.obs.digest``) to the ``digests.jsonl`` sink."""
        self.digests.append(digest)
        if self._digest_sink is not None:
            self._digest_sink.write(digest_to_dict(digest))

    def write_profile(self, profile: Dict[str, Any]) -> str:
        path = self.path(PROFILE)
        with open(path, "w") as f:
            json.dump(profile, f, indent=2, default=str)
        return path

    # ------------------------------------------------------------------
    def flush(self) -> Optional[str]:
        """Export the Chrome trace (when the trace sink is on); returns its
        path.  Explicitly IDEMPOTENT: a flush with no spans recorded since
        the previous flush re-exports nothing and returns the cached path —
        so a caller flushing after the trainer flushed costs no second
        export, and a reader mid-inspecting ``trace.json`` never sees it
        rewritten gratuitously.  Call after every epoch or once at the end."""
        if "trace" not in self.sinks or not self.tracer.spans:
            return self._trace_path
        if len(self.tracer.spans) == self._flushed_spans:
            return self._trace_path
        self._trace_path = self.tracer.export_chrome(
            self.path(TRACE), self.trace_clock)
        self._flushed_spans = len(self.tracer.spans)
        return self._trace_path

    def close(self) -> None:
        self.flush()
        for s in (self._fb_sink, self._knob_sink, self._metric_sink,
                  self._alert_sink, self._digest_sink):
            if s is not None:
                s.close()

    def render_summary(self) -> str:
        return self.registry.render()


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

@dataclass
class RunRecord:
    """One recorded run, loaded back from disk."""
    run_dir: str
    manifest: Dict[str, Any] = field(default_factory=dict)
    feedback: List[RoundFeedback] = field(default_factory=list)
    knobs: List[ControlKnobs] = field(default_factory=list)
    metrics: List[Dict[str, Any]] = field(default_factory=list)
    alerts: List[HealthAlert] = field(default_factory=list)
    digests: List[RoundDigest] = field(default_factory=list)

    @property
    def num_rounds(self) -> int:
        return len(self.feedback)


def load_run(run_dir: str) -> RunRecord:
    rec = RunRecord(run_dir=run_dir)
    mpath = os.path.join(run_dir, MANIFEST)
    if os.path.exists(mpath):
        with open(mpath) as f:
            rec.manifest = json.load(f)
    fpath = os.path.join(run_dir, FEEDBACK)
    if os.path.exists(fpath):
        rec.feedback = [feedback_from_dict(d) for d in load_jsonl(fpath)]
    kpath = os.path.join(run_dir, KNOBS)
    if os.path.exists(kpath):
        rec.knobs = [knobs_from_dict(d) for d in load_jsonl(kpath)]
    mpath = os.path.join(run_dir, METRICS)
    if os.path.exists(mpath):
        rec.metrics = load_jsonl(mpath)
    apath = os.path.join(run_dir, ALERTS)
    if os.path.exists(apath):
        rec.alerts = [alert_from_dict(d) for d in load_jsonl(apath)]
    dpath = os.path.join(run_dir, DIGESTS)
    if os.path.exists(dpath):
        rec.digests = [digest_from_dict(d) for d in load_jsonl(dpath)]
    return rec
