"""Cross-run divergence diffing: load two recorded runs, align their
rounds, and localize the FIRST place they part ways.  Port of
``repro/obs/diff.py`` (pure Python, copied).

"These two runs should have been identical — where did they split?" is
the question every reproducibility bug starts with.  With the recorder's
artifacts the answer is mechanical:

  * ``knobs.jsonl``    — the controller's decision each round.  The first
    knob mismatch is a **controller** divergence: the runs were steered
    differently.  :func:`diff_runs` additionally replays each run's own
    feedback through its own manifest-rebuilt suite (``repro_torch.obs.replay``)
    to say whether each side's decisions are still a pure function of its
    history — separating "the controller changed" from "the controller
    faithfully reacted to different measurements";
  * ``digests.jsonl``  — the committed global state, content-addressed.
    A digest mismatch at EQUAL knobs is a **numeric** divergence: same
    steering, different bits (a kernel change, a nondeterministic op, a
    different backend).  The digest sketches give its magnitude;
  * ``feedback.jsonl`` — the measurements.  A feedback mismatch at equal
    knobs and equal digests is a **measurement** divergence: the training
    state agreed but the environment readings (timing model, wire pricing)
    did not.

Fields compare exactly (the JSONL round-trips floats bit-exactly; that is
the recorder's foundation) with NaN == NaN — NaN is the schema's "not
measured" marker, and two unmeasured fields agree.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.recorder import RunRecord, load_run

# divergence kinds, most specific wins (knobs checked before digests
# before feedback — steering differences explain everything downstream)
KIND_CONTROLLER = "controller"
KIND_NUMERIC = "numeric"
KIND_MEASUREMENT = "measurement"


@dataclass(frozen=True)
class DiffEntry:
    """One field that disagreed at one aligned round."""
    round_index: int
    field: str                   # e.g. "knobs.codec", "digest.global_digest"
    kind: str                    # controller | numeric | measurement
    a: Any
    b: Any

    def __str__(self) -> str:
        return (f"round {self.round_index} [{self.kind}] {self.field}: "
                f"{self.a!r} != {self.b!r}")


@dataclass
class RunDiff:
    """The full comparison of two recorded runs."""
    dir_a: str
    dir_b: str
    rounds_a: int = 0
    rounds_b: int = 0
    config_diffs: List[Tuple[str, Any, Any]] = field(default_factory=list)
    entries: List[DiffEntry] = field(default_factory=list)
    # replay self-consistency per side (None: replay not possible — no
    # manifest, e.g. a feedback-sink-off run)
    replay_ok_a: Optional[bool] = None
    replay_ok_b: Optional[bool] = None

    @property
    def identical(self) -> bool:
        return not self.entries and self.rounds_a == self.rounds_b

    @property
    def first_divergence(self) -> Optional[DiffEntry]:
        """The earliest mismatch; ties within a round break by kind
        (controller < numeric < measurement — upstream explains
        downstream)."""
        if not self.entries:
            return None
        order = {KIND_CONTROLLER: 0, KIND_NUMERIC: 1, KIND_MEASUREMENT: 2}
        return min(self.entries,
                   key=lambda e: (e.round_index, order[e.kind]))

    @property
    def kind(self) -> Optional[str]:
        """The first divergence's classification (None: identical)."""
        fd = self.first_divergence
        return fd.kind if fd is not None else None

    def report(self) -> str:
        lines = [f"diff {self.dir_a} vs {self.dir_b}",
                 f"  rounds: {self.rounds_a} vs {self.rounds_b}"]
        for path, a, b in self.config_diffs:
            lines.append(f"  config {path}: {a!r} != {b!r}")
        if self.identical:
            lines.append("  identical")
            return "\n".join(lines)
        fd = self.first_divergence
        if fd is not None:
            lines.append(f"  FIRST DIVERGENCE: {fd}")
        if self.replay_ok_a is not None or self.replay_ok_b is not None:
            lines.append(f"  replay self-consistent: "
                         f"a={self.replay_ok_a} b={self.replay_ok_b}")
        for e in self.entries[:20]:
            lines.append(f"  {e}")
        if len(self.entries) > 20:
            lines.append(f"  ... {len(self.entries) - 20} more")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# comparison primitives
# ---------------------------------------------------------------------------

def _eq(a: Any, b: Any) -> bool:
    """Exact equality with NaN == NaN (recursively through containers —
    the feedback maps hold float values)."""
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) and math.isnan(b):
            return True
        return a == b
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    return a == b


def _flat_config_diffs(ca: Dict[str, Any], cb: Dict[str, Any],
                       prefix: str = "") -> List[Tuple[str, Any, Any]]:
    out: List[Tuple[str, Any, Any]] = []
    for key in sorted(set(ca) | set(cb)):
        path = f"{prefix}{key}"
        if path.startswith("obs."):
            continue        # run_id / out_dir always differ between runs
        va, vb = ca.get(key), cb.get(key)
        if isinstance(va, dict) and isinstance(vb, dict):
            out.extend(_flat_config_diffs(va, vb, prefix=f"{path}."))
        elif not _eq(va, vb):
            out.append((path, va, vb))
    return out


def _dataclass_field_diffs(r: int, a: Any, b: Any, prefix: str, kind: str
                           ) -> List[DiffEntry]:
    da, db = asdict(a), asdict(b)
    return [DiffEntry(r, f"{prefix}.{k}", kind, da[k], db[k])
            for k in da if not _eq(da[k], db.get(k))]


def _replay_consistent(rec: RunRecord) -> Optional[bool]:
    if not rec.manifest or not rec.knobs:
        return None
    from repro_torch.obs.replay import replay_run
    try:
        return replay_run(rec.run_dir).matches
    except Exception:
        return None


# ---------------------------------------------------------------------------
# the diff
# ---------------------------------------------------------------------------

def diff_runs(dir_a: str, dir_b: str, *,
              compare_feedback: bool = True) -> RunDiff:
    """Align two recorded runs round by round and report every mismatch,
    classified (see module docstring).  ``first_divergence`` answers the
    headline question; ``entries`` holds the full field-level fallout.

    Knob fields diverging at round r classify everything as *controller*
    from r on; a digest mismatch while knobs still agreed is *numeric*;
    feedback-only disagreement (set ``compare_feedback=False`` to skip,
    e.g. when comparing runs across machines whose timing models
    legitimately differ) is *measurement*.
    """
    ra, rb = load_run(dir_a), load_run(dir_b)
    out = RunDiff(dir_a=dir_a, dir_b=dir_b,
                  rounds_a=ra.num_rounds, rounds_b=rb.num_rounds)
    if ra.manifest and rb.manifest:
        out.config_diffs = _flat_config_diffs(
            ra.manifest.get("config", {}), rb.manifest.get("config", {}))

    n = min(ra.num_rounds, rb.num_rounds)
    knobs_diverged = False
    for r in range(n):
        # 1) steering: the knobs in force during round r
        if r < len(ra.knobs) and r < len(rb.knobs):
            kd = _dataclass_field_diffs(r, ra.knobs[r], rb.knobs[r],
                                        "knobs", KIND_CONTROLLER)
            if kd:
                knobs_diverged = True
            out.entries.extend(kd)
        # 2) numerics: the committed state digest
        if r < len(ra.digests) and r < len(rb.digests):
            da, db = ra.digests[r], rb.digests[r]
            kind = KIND_CONTROLLER if knobs_diverged else KIND_NUMERIC
            for f in ("global_digest", "opt_digest", "gan_digest",
                      "rolled_back"):
                va, vb = getattr(da, f), getattr(db, f)
                if not _eq(va, vb):
                    out.entries.append(
                        DiffEntry(r, f"digest.{f}", kind, va, vb))
        # 3) measurements: the feedback record
        if compare_feedback and r < len(ra.feedback) \
                and r < len(rb.feedback):
            kind = KIND_CONTROLLER if knobs_diverged else KIND_MEASUREMENT
            out.entries.extend(_dataclass_field_diffs(
                r, ra.feedback[r], rb.feedback[r], "feedback", kind))

    # numeric state diverging is upstream of the *next* round's
    # measurements, but a digest mismatch in round r with agreeing
    # feedback IN round r stays classified per-stream above; the
    # first_divergence tie-break (controller < numeric < measurement)
    # already surfaces the right cause.
    out.replay_ok_a = _replay_consistent(ra)
    out.replay_ok_b = _replay_consistent(rb)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="diff two flight-recorder run directories")
    p.add_argument("run_a")
    p.add_argument("run_b")
    p.add_argument("--no-feedback", action="store_true",
                   help="skip feedback (measurement) comparison")
    args = p.parse_args(argv)
    d = diff_runs(args.run_a, args.run_b,
                  compare_feedback=not args.no_feedback)
    print(d.report())
    return 0 if d.identical else 1


if __name__ == "__main__":          # pragma: no cover
    raise SystemExit(main())
