"""Per-round controllers: measured feedback in, knob decisions out.
Port of ``repro/control/controllers.py`` (pure Python, copied).

Each controller is a pure function over the round history —
``controller(history, knobs) -> knobs`` — behind the :class:`Controller`
protocol; :class:`ControllerSuite` chains them in a fixed order.  Purity is
the point: a controller holds tuning constants, never engine state, so
decisions are replayable from the feedback log alone and a controller can
be unit-tested against a synthetic history.

  * :class:`CodecController`    — walks the bytes-vs-delta-error frontier
    cheapest-codec-first (wire bytes are ANALYTIC per codec —
    ``fed/transport.predict_codec_bytes`` — only the error needs live
    probing), committing to the cheapest codec whose measured error fits
    the budget.  Probing cheapest-first is what makes the adaptive run's
    total bytes <= the best static codec's: every probe is cheaper than
    the codec it ends up committing to.
  * :class:`SigmaController`    — replays the accountant's spend from the
    feedback log and bisects the RDP epsilon curve
    (``RDPAccountant.projected_epsilon``) for the smallest sigma that keeps
    the whole remaining horizon inside the ``(epsilon, delta)`` budget.
    Solved fresh every round, so early over-estimates self-correct and the
    budget is never exceeded (pinned).
  * :class:`SplitController`    — replans device selection when measured
    load imbalance drifts past a threshold, and assigns the leaky stage
    only to boundary indices whose measured dCor exceeds the leakage
    threshold (SplitEasy / split-leakage motivation: noise what the attack
    actually reads).
  * :class:`DeadlineController` — sets the sync straggler deadline at a
    quantile of the measured per-client finish-time distribution.
"""
from __future__ import annotations

import math
from typing import Dict, List, Protocol, Sequence, Tuple

from repro_torch.control.feedback import ControlKnobs, RoundFeedback
from repro_torch.fed.transport import predict_codec_bytes
from repro_torch.privacy.defenses import RDPAccountant, min_feasible_sigma


class Controller(Protocol):
    """One knob's decision rule: pure over the feedback history."""
    name: str

    def __call__(self, history: List[RoundFeedback],
                 knobs: ControlKnobs) -> ControlKnobs: ...


class ControllerSuite:
    """Chains controllers in order; each sees the previous one's knobs."""

    def __init__(self, controllers: Sequence[Controller]):
        self.controllers = list(controllers)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.controllers)

    def __call__(self, history: List[RoundFeedback],
                 knobs: ControlKnobs) -> ControlKnobs:
        for c in self.controllers:
            knobs = c(history, knobs)
        return knobs


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

class CodecController:
    """Cheapest-first frontier walk over the candidate codecs.

    Candidates are ranked by their ANALYTIC wire bytes for this uplink tree
    (``predict_codec_bytes``); each round the controller walks that ranking
    and picks the first codec that is either unprobed (probe it — its error
    is the one unknown) or measured within ``error_budget`` (commit).  A
    committed codec whose error later drifts over budget is walked past
    automatically.  ``target_uplink_s`` short-circuits to lossless when the
    measured bandwidth ships the native tree inside the target.
    """
    name = "codec"

    def __init__(self, candidates: Sequence[str], error_budget: float,
                 leaf_sizes: Sequence[int], *, topk_frac: float = 0.01,
                 target_uplink_s: float = 0.0):
        self.error_budget = float(error_budget)
        self.target_uplink_s = float(target_uplink_s)
        self.topk_frac = float(topk_frac)
        self.bytes_of = {
            name: predict_codec_bytes(name, leaf_sizes,
                                      topk_frac=self.topk_frac)
            for name in dict.fromkeys(candidates)}   # dedup, keep order
        self.ranked = sorted(self.bytes_of, key=self.bytes_of.get)

    def __call__(self, history: List[RoundFeedback],
                 knobs: ControlKnobs) -> ControlKnobs:
        # latest measured error per codec ("none" is lossless by
        # construction); rounds with no landed uplink measure nothing.
        # Round 0 has no history: the walk below starts probing at the
        # cheapest candidate immediately.
        seen: Dict[str, float] = {"none": 0.0}
        for fb in history:
            if not math.isnan(fb.codec_error):
                seen[fb.codec] = fb.codec_error
        bps = history[-1].uplink_bps if history else 0.0
        if (self.target_uplink_s > 0 and bps > 0 and "none" in self.bytes_of
                and 8.0 * self.bytes_of["none"] / bps <= self.target_uplink_s):
            return knobs.replace(codec="none", topk_frac=self.topk_frac)
        for cand in self.ranked:
            if cand not in seen or seen[cand] <= self.error_budget:
                return knobs.replace(codec=cand, topk_frac=self.topk_frac)
        # every candidate measured over budget: best-effort WITHIN the
        # user's candidate list — the most expensive (least lossy) one,
        # never a codec the config deliberately excluded
        return knobs.replace(codec=self.ranked[-1],
                             topk_frac=self.topk_frac)


# ---------------------------------------------------------------------------
# sigma
# ---------------------------------------------------------------------------

class SigmaController:
    """Spend a total ``(epsilon_budget, delta)`` over ``horizon_rounds``.

    Replays the realized spend — (dp_steps, sigma) per past round — into a
    fresh accountant, then bisects ``projected_epsilon`` for the smallest
    sigma under which the REMAINING rounds (at the projected steps/round)
    still land inside the budget.  Because every round re-solves with the
    realized spend, and the bisection only ever returns budget-feasible
    sigmas, the cumulative epsilon never crosses the budget (pinned
    against the accountant in tests) — provided the budget is REACHABLE
    (at least the horizon's spend at ``sigma_max``; an unreachable budget
    clamps to ``sigma_max``, the most noise it can buy, and overspends by
    construction) and the round length never exceeds the projection
    (steps/round is projected as the max of the hint and every observed
    round, so only growing a round PAST the historical maximum can
    overshoot).  Shrinking sigma by less than ``rel_change`` is skipped
    (hysteresis) to bound DP-SGD recompiles; noise INCREASES are always
    applied — hysteresis must never relax the budget.
    """
    name = "sigma"

    def __init__(self, epsilon_budget: float, horizon_rounds: int,
                 delta: float = 1e-5, sample_rate: float = 1.0, *,
                 steps_per_round_hint: int = 1, sigma_min: float = 1e-2,
                 sigma_max: float = 1e4, rel_change: float = 0.05):
        self.budget = float(epsilon_budget)
        self.horizon = int(horizon_rounds)
        self.delta = float(delta)
        self.sample_rate = float(sample_rate)
        self.steps_hint = max(1, int(steps_per_round_hint))
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.rel_change = float(rel_change)

    def _solve(self, acct: RDPAccountant, steps: int) -> float:
        # the shared property-tested inverter; infeasible budgets clamp to
        # sigma_max (maximum protection) by its contract
        return min_feasible_sigma(
            lambda s: acct.projected_epsilon(steps, self.delta, s)
            <= self.budget,
            self.sigma_min, self.sigma_max)

    def __call__(self, history: List[RoundFeedback],
                 knobs: ControlKnobs) -> ControlKnobs:
        if self.budget <= 0 or self.horizon <= 0:
            return knobs
        acct = RDPAccountant(max(knobs.sigma, self.sigma_min),
                             self.sample_rate)
        # project with the LARGEST round seen (or hinted): a conservative
        # steps/round keeps the feasibility check sound when round lengths
        # fluctuate below their historical maximum
        steps_per_round = self.steps_hint
        for fb in history:
            if fb.dp_steps > 0:
                acct.step(fb.dp_steps, noise_multiplier=fb.sigma)
                steps_per_round = max(steps_per_round, fb.dp_steps)
        remaining = max(1, self.horizon - len(history))
        sigma = self._solve(acct, remaining * steps_per_round)
        if (sigma < knobs.sigma
                and (knobs.sigma - sigma) / knobs.sigma < self.rel_change):
            return knobs                   # hysteresis: only skip DECREASES
        return knobs.replace(sigma=sigma)


# ---------------------------------------------------------------------------
# split
# ---------------------------------------------------------------------------

class SplitController:
    """Replan the split when the measurements drift.

    Load rule: when max/mean measured device load exceeds
    ``imbalance_threshold``, switch the selection strategy to
    ``replan_strategy`` (the paper's sorted_multi winner) — a plan-level
    regroup, re-run through ``core/selection``.

    Leakage rule: per boundary INDEX, take the worst measured dCor across
    clients; indices above ``dcor_threshold`` get ``leaky_stage`` (dp
    clip+noise by default), the rest keep the config's base stage — noise
    goes only where the attack actually reads.
    """
    name = "split"

    def __init__(self, *, imbalance_threshold: float = 2.0,
                 dcor_threshold: float = 0.5,
                 replan_strategy: str = "sorted_multi",
                 leaky_stage: str = "dp", base_stage: str = "identity"):
        self.imbalance_threshold = float(imbalance_threshold)
        self.dcor_threshold = float(dcor_threshold)
        self.replan_strategy = replan_strategy
        self.leaky_stage = leaky_stage
        self.base_stage = base_stage or "identity"

    def __call__(self, history: List[RoundFeedback],
                 knobs: ControlKnobs) -> ControlKnobs:
        if not history:
            return knobs
        last = history[-1]
        loads = list(last.device_loads.values())
        if len(loads) > 1:
            mean = sum(loads) / len(loads)
            if (mean > 0 and max(loads) / mean > self.imbalance_threshold
                    and knobs.split_strategy != self.replan_strategy):
                knobs = knobs.replace(split_strategy=self.replan_strategy)
        if last.boundary_dcor:
            worst: Dict[int, float] = {}
            for dcors in last.boundary_dcor.values():
                for b, v in enumerate(dcors):
                    worst[b] = max(worst.get(b, 0.0), float(v))
            stage_map = {b: (self.leaky_stage if v > self.dcor_threshold
                             else self.base_stage)
                         for b, v in worst.items()}
            # all-base == the uniform config stage: normalize to None so a
            # no-leak round never registers as a knob change (a map diff
            # triggers a full split-program regroup + engine reprice)
            if all(s == self.base_stage for s in stage_map.values()):
                stage_map = None
            old_map = (dict(knobs.stage_by_boundary)
                       if knobs.stage_by_boundary is not None else None)
            if stage_map != old_map:
                knobs = knobs.replace(stage_by_boundary=stage_map)
        return knobs


# ---------------------------------------------------------------------------
# deadline
# ---------------------------------------------------------------------------

class DeadlineController:
    """Sync straggler deadline from the measured finish-time distribution.

    Takes the ``quantile`` of all per-client virtual finish times over the
    last ``window`` rounds and stretches it by ``slack`` — clients inside
    the bulk of the distribution land, tail stragglers are cut.  Needs
    ``warmup`` rounds of feedback before the first decision; small
    (<5% relative) retunes are skipped.

    Pipelining-aware: when the pipelined split executor changes K between
    rounds, historical finish times were measured under a different
    overlap schedule.  Each round's times are rescaled by
    ``fb.pipeline_speedup / current.pipeline_speedup`` — the analytic
    sequential/pipelined ratio the schedule emitted (finish time scales
    inversely with it) — so the quantile is taken over a distribution
    expressed in *current-schedule* seconds.  With K fixed the ratio is
    1 everywhere and the controller is bit-identical to before.
    """
    name = "deadline"

    def __init__(self, *, quantile: float = 0.9, slack: float = 1.25,
                 warmup: int = 1, window: int = 5):
        self.quantile = float(quantile)
        self.slack = float(slack)
        self.warmup = int(warmup)
        self.window = int(window)

    def __call__(self, history: List[RoundFeedback],
                 knobs: ControlKnobs) -> ControlKnobs:
        if len(history) < self.warmup:
            return knobs
        cur = getattr(history[-1], "pipeline_speedup", 1.0) or 1.0
        times = sorted(
            t * (getattr(fb, "pipeline_speedup", 1.0) or 1.0) / cur
            for fb in history[-self.window:]
            for t in fb.client_finish_s.values())
        if not times:
            return knobs
        idx = min(len(times) - 1,
                  max(0, int(math.ceil(self.quantile * len(times))) - 1))
        deadline = times[idx] * self.slack
        if knobs.deadline_s > 0 and \
                abs(deadline - knobs.deadline_s) / knobs.deadline_s < 0.05:
            return knobs
        return knobs.replace(deadline_s=deadline)


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

def make_controllers(cfg, *, leaf_sizes: Sequence[int],
                     steps_per_round_hint: int = 1) -> ControllerSuite:
    """cfg (RunConfig) -> the suite named by ``cfg.control.controllers``.

    ``leaf_sizes``: leaf element counts of the uplinked tree (codec byte
    prediction); ``steps_per_round_hint``: expected DP releases per round
    before the first feedback arrives (sigma controller).
    """
    ctl = cfg.control
    order = {"codec": 0, "sigma": 1, "split": 2, "deadline": 3}
    built: List[Controller] = []
    for name in sorted(dict.fromkeys(ctl.controllers), key=order.get):
        if name == "codec":
            built.append(CodecController(
                ctl.codec_candidates, ctl.error_budget, leaf_sizes,
                topk_frac=cfg.fed.topk_frac,
                target_uplink_s=ctl.target_uplink_s))
        elif name == "sigma":
            built.append(SigmaController(
                ctl.epsilon_budget, ctl.horizon_rounds, cfg.privacy.delta,
                cfg.privacy.sample_rate,
                steps_per_round_hint=steps_per_round_hint,
                sigma_min=ctl.sigma_min, sigma_max=ctl.sigma_max,
                rel_change=ctl.sigma_rel_change))
        elif name == "split":
            built.append(SplitController(
                imbalance_threshold=ctl.imbalance_threshold,
                dcor_threshold=ctl.dcor_threshold,
                replan_strategy=ctl.replan_strategy,
                leaky_stage=ctl.leaky_stage,
                base_stage=cfg.split.boundary_stage))
        elif name == "deadline":
            built.append(DeadlineController(
                quantile=ctl.deadline_quantile, slack=ctl.deadline_slack,
                warmup=ctl.warmup_rounds))
    return ControllerSuite(built)
