"""Flight recorder + watchtower for the federated split engine (port of
``repro/obs``): tracing, metrics, recording + replay, profiling, and the
detection layer over it — health monitors, content digests, run diffing.

  * :mod:`repro_torch.obs.trace`    — two-clock nested spans + Chrome-trace
    export
  * :mod:`repro_torch.obs.metrics`  — typed counter/gauge/histogram
    registry + JSONL
  * :mod:`repro_torch.obs.recorder` — per-run persistence of feedback/knobs/
    metrics/alerts/digests
  * :mod:`repro_torch.obs.replay`   — offline controller replay over
    recorded logs
  * :mod:`repro_torch.obs.profile`  — kernel timing (CUDA events on the
    card) feeding the H100 roofline model
  * :mod:`repro_torch.obs.health`   — per-round numeric-health monitors +
    policies
  * :mod:`repro_torch.obs.digest`   — content digests of the committed
    global state
  * :mod:`repro_torch.obs.diff`     — cross-run divergence localization
  * :mod:`repro_torch.obs.regress`  — the bench regression gate over
    ``BENCH_*.json`` files (run as ``python -m repro_torch.obs.regress``)
"""
from repro_torch.obs.diff import DiffEntry, RunDiff, diff_runs
from repro_torch.obs.digest import (RoundDigest, digest_from_dict,
                                    digest_to_dict, state_digest,
                                    tree_digest, tree_sketch)
from repro_torch.obs.health import (HEALTH_CHECKS, HealthAbort, HealthAlert,
                                    HealthMonitor, alert_from_dict,
                                    alert_to_dict)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, JsonlSink,
                                     MetricsRegistry, load_jsonl,
                                     observe_round)
from repro_torch.obs.profile import (KernelProfile, profile_agg_fuse,
                                     profile_boundary_fuse, profile_call,
                                     profile_dp_clip, profile_engine_kernels,
                                     profile_fedavg)
from repro_torch.obs.recorder import (FlightRecorder, RunRecord,
                                      feedback_from_dict, feedback_to_dict,
                                      knobs_from_dict, knobs_to_dict,
                                      load_run)
from repro_torch.obs.replay import (ReplayResult, replay_decisions,
                                    replay_run, suite_from_manifest)
from repro_torch.obs.trace import Span, Tracer, validate_chrome_trace

__all__ = [
    "DiffEntry", "RunDiff", "diff_runs",
    "RoundDigest", "digest_from_dict", "digest_to_dict", "state_digest",
    "tree_digest", "tree_sketch",
    "HEALTH_CHECKS", "HealthAbort", "HealthAlert", "HealthMonitor",
    "alert_from_dict", "alert_to_dict",
    "Counter", "Gauge", "Histogram", "JsonlSink", "MetricsRegistry",
    "load_jsonl", "observe_round",
    "KernelProfile", "profile_agg_fuse", "profile_boundary_fuse",
    "profile_call", "profile_dp_clip", "profile_engine_kernels",
    "profile_fedavg",
    "FlightRecorder", "RunRecord", "feedback_from_dict", "feedback_to_dict",
    "knobs_from_dict", "knobs_to_dict", "load_run",
    "ReplayResult", "replay_decisions", "replay_run", "suite_from_manifest",
    "Span", "Tracer", "validate_chrome_trace",
]
