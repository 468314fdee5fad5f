"""Offline controller replay — the on-ramp to trace-driven simulation.
Port of ``repro/obs/replay.py`` (pure Python, copied).

The controllers are pure functions ``(history, knobs) -> knobs``, so
a recorded run's knob decisions are a deterministic fold over its feedback
log:

    decision_r = suite(history[:r], decision_{r-1}),
    decision_{-1} = knobs_from_config(cfg)

which is EXACTLY the fold the live trainer runs before each round (the
adaptive branch of ``FSLGANTrainer.train_epoch``).  :func:`replay_run`
loads a recorded run directory, rebuilds the controller suite from its
manifest, re-runs the fold over the recorded feedback, and compares
against the recorded knob log — bit-exact equality is pinned in tests
(floats round-trip exactly through the JSONL; :class:`ControlKnobs` holds
no NaN fields, so frozen-dataclass equality is the right comparison).

This is what makes controller tuning an offline activity: edit a
controller constant, replay a week of recorded feedback, diff the decision
sequences — no engine, no training, no GPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.config import RunConfig
from repro_torch.control.controllers import ControllerSuite, make_controllers
from repro_torch.control.feedback import (ControlKnobs, RoundFeedback,
                                    knobs_from_config)
from repro_torch.obs.recorder import RunRecord, load_run


def replay_decisions(suite: ControllerSuite,
                     history: Sequence[RoundFeedback],
                     initial_knobs: ControlKnobs) -> List[ControlKnobs]:
    """The pure decision fold: what knobs were in force during each
    recorded round.  ``decisions[r]`` is the suite's output given the
    feedback of rounds ``0..r-1`` — the trainer applies it BEFORE round
    ``r`` runs."""
    decisions: List[ControlKnobs] = []
    knobs = initial_knobs
    for r in range(len(history)):
        knobs = suite(list(history[:r]), knobs)
        decisions.append(knobs)
    return decisions


def suite_from_manifest(manifest: dict) -> ControllerSuite:
    """Rebuild the exact live controller suite from a run manifest."""
    cfg = RunConfig.from_dict(manifest["config"])
    return make_controllers(
        cfg, leaf_sizes=manifest["leaf_sizes"],
        steps_per_round_hint=manifest.get("steps_per_round_hint", 1))


@dataclass
class ReplayResult:
    record: RunRecord
    decisions: List[ControlKnobs] = field(default_factory=list)
    mismatches: List[int] = field(default_factory=list)   # round indices

    @property
    def matches(self) -> bool:
        """True iff every replayed decision equals the recorded one."""
        return not self.mismatches and \
            len(self.decisions) == len(self.record.knobs)

    def diff(self) -> List[str]:
        out = []
        for r in self.mismatches:
            out.append(f"round {r}: replayed {self.decisions[r]} != "
                       f"recorded {self.record.knobs[r]}")
        return out


def replay_run(run_dir: str, *,
               suite: Optional[ControllerSuite] = None) -> ReplayResult:
    """Load a recorded run and replay its feedback through the (rebuilt or
    provided) controller suite; compare against the recorded knob log.

    A frozen-mode recording replays trivially (empty suite, knobs constant
    at the config seed); an adaptive recording must reproduce every codec
    swap, sigma rebind, split regroup and deadline retune bit-exactly —
    any mismatch means a controller stopped being a pure function of the
    feedback history, which is exactly the regression this guards."""
    rec = load_run(run_dir)
    if not rec.manifest:
        raise FileNotFoundError(f"{run_dir}: no manifest.json — "
                                "was the run recorded with the feedback "
                                "sink enabled?")
    cfg = RunConfig.from_dict(rec.manifest["config"])
    if suite is None:
        # mirror the trainer's adaptive gate: a frozen run never consults
        # the suite, so replaying one through controllers that were never
        # live would manufacture spurious mismatches
        if cfg.control.mode == "adaptive" and cfg.control.controllers:
            suite = suite_from_manifest(rec.manifest)
        else:
            suite = ControllerSuite([])
    decisions = replay_decisions(suite, rec.feedback, knobs_from_config(cfg))
    result = ReplayResult(record=rec, decisions=decisions)
    for r, (got, want) in enumerate(zip(decisions, rec.knobs)):
        if got != want:
            result.mismatches.append(r)
    return result
