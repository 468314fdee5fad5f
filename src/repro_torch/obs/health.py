"""Per-round numeric-health monitors over the live training loop.  Port of
``repro/obs/health.py``.

The paper's setting — long-running GAN training on user devices — is
exactly where a NaN'd discriminator or a silently-diverged replica poisons
the global model with nobody watching.  The flight recorder
*collects*; this module *detects*: after every round the trainer hands the
:class:`HealthMonitor` the round's :class:`~repro_torch.control.feedback.
RoundFeedback` plus the aggregated global tree, and gets back a list of
typed :class:`HealthAlert` records.  What happens next is policy
(``cfg.obs.health.policy``), applied by the trainer:

  ==========  =============================================================
  policy      effect
  ==========  =============================================================
  record      alerts go to ``alerts.jsonl`` + the metrics registry, nothing
              else — the training trajectory stays bit-exact with monitors
              off (monitors only read state, never write it)
  warn        record + ``warnings.warn`` per alert
  abort       fatal alerts raise :class:`HealthAbort`; warn-severity alerts
              behave as ``warn``
  rollback    fatal *recoverable* alerts restore the last healthy global /
              optimizer state so one poisoned round degrades gracefully;
              non-recoverable fatals (epsilon overspend — rolling back
              params does not unspend the privacy budget) degrade to warn
  ==========  =============================================================

Checks (:data:`HEALTH_CHECKS`) and what trips them:

  * ``nonfinite_params`` — a tree scan on the params' own device counts
    NaN/Inf in the aggregated global params (fatal, recoverable);
  * ``nonfinite_loss``   — D or G loss went NaN/Inf (fatal, recoverable);
  * ``loss_ratio``       — D/G loss ratio outside ``loss_ratio_max``
    either way: the classic mode-collapse / overpowered-D heuristic (warn);
  * ``update_norm``      — this round's global-update L2 exceeds
    ``update_norm_factor`` x the window median (divergence onset) (warn);
  * ``codec_error_spike``— measured codec delta-error jumped
    ``codec_error_factor`` x above its window median (warn);
  * ``epsilon_overspend``— cumulative DP spend crossed
    ``epsilon_budget`` (> 0 enables) (fatal, NOT recoverable);
  * ``straggler_runaway``— straggler rate exceeded ``straggler_rate_max``
    for a full window of rounds (warn).

Windowed checks need ``min_history`` prior rounds before they arm — a
fresh run's first rounds are legitimately noisy.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.control.feedback import RoundFeedback
from repro_torch.obs.digest import leaves_with_path

HEALTH_CHECKS = ("nonfinite_params", "nonfinite_loss", "loss_ratio",
                 "update_norm", "codec_error_spike", "epsilon_overspend",
                 "straggler_runaway")

SEV_WARN = "warn"
SEV_FATAL = "fatal"


class HealthAbort(RuntimeError):
    """Raised by the trainer under ``policy='abort'`` on a fatal alert."""

    def __init__(self, alert: "HealthAlert"):
        super().__init__(f"health abort at round {alert.round_index}: "
                         f"{alert.check}: {alert.message}")
        self.alert = alert


@dataclass(frozen=True)
class HealthAlert:
    """One tripped health check — the typed record ``alerts.jsonl`` holds.

    ``recoverable`` says whether restoring the last healthy snapshot
    actually fixes the condition: a NaN'd aggregate is recoverable, an
    overspent epsilon budget is not (the spend is monotone)."""
    round_index: int
    check: str                      # one of HEALTH_CHECKS
    severity: str                   # "warn" | "fatal"
    value: float                    # the measured quantity
    threshold: float                # what it was compared against
    message: str
    recoverable: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def alert_to_dict(a: HealthAlert) -> Dict[str, Any]:
    return asdict(a)


def alert_from_dict(d: Dict[str, Any]) -> HealthAlert:
    return HealthAlert(**d)


# ---------------------------------------------------------------------------
# tree scans — one pass each over the global tree, on its leaves' device;
# only the final count or norm comes back to the host
# ---------------------------------------------------------------------------

def _float_leaves(tree) -> List[torch.Tensor]:
    out = []
    for _, leaf in leaves_with_path(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point():
            out.append(t)
    return out


def _tree_nonfinite(tree) -> int:
    """Count of non-finite entries across all floating leaves."""
    ls = _float_leaves(tree)
    if not ls:
        return 0
    return int(sum(torch.sum(~torch.isfinite(l)) for l in ls))


def _tree_l2(tree) -> float:
    """Global L2 norm across all floating leaves (fp32 sums, as the
    reference)."""
    ls = _float_leaves(tree)
    if not ls:
        return 0.0
    return float(torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                                for l in ls)))


def _tree_update_l2(new, base) -> float:
    """L2 norm of ``new - base`` (this round's aggregate update)."""
    ns, bs = _float_leaves(new), _float_leaves(base)
    if not ns:
        return 0.0
    return float(torch.sqrt(sum(
        torch.sum(torch.square(n.to(torch.float32) - b.to(torch.float32)))
        for n, b in zip(ns, bs))))


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return float("nan")
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


# ---------------------------------------------------------------------------
# monitor
# ---------------------------------------------------------------------------

class HealthMonitor:
    """Stateful window-keeper over the checks above.

    Read-only with respect to training: every check consumes measurements
    (the feedback record, the aggregated tree) and produces alerts — it
    never touches params, optimizer state, or RNG, which is why
    ``policy='record'`` is bit-exact with monitors off.  The windows
    (update norms, codec errors, straggler flags) live here rather than in
    ``RoundFeedback`` so the feedback schema stays purely *measured*.
    """

    def __init__(self, cfg):
        """``cfg`` is a :class:`repro_torch.config.HealthConfig`."""
        self.cfg = cfg
        self._update_norms: List[float] = []
        self._codec_errors: List[float] = []
        self._straggler_hot: List[bool] = []
        # NaN doubles as the schema's "not measured" marker; a loss only
        # counts as *gone* NaN after it has ever been finite.
        self._loss_seen = {"d_loss": False, "g_loss": False}

    # ------------------------------------------------------------------
    def check_round(self, fb: RoundFeedback, *, params: Any = None,
                    update_base: Any = None) -> List[HealthAlert]:
        """Run every armed check against one completed round.

        ``params`` is the round's aggregated global tree (NaN scan +
        update norm); ``update_base`` the round-*start* global tree the
        update is measured against.  Both optional — feedback-only checks
        still run when the trees are not provided (e.g. offline over a
        loaded run).
        """
        c = self.cfg
        r = fb.round_index
        alerts: List[HealthAlert] = []

        # -- fatal: non-finite aggregate / losses --------------------------
        if params is not None:
            bad = int(_tree_nonfinite(params))
            if bad:
                alerts.append(HealthAlert(
                    r, "nonfinite_params", SEV_FATAL, float(bad), 0.0,
                    f"{bad} non-finite entries in aggregated global params"))
        for name, val in (("d_loss", fb.d_loss), ("g_loss", fb.g_loss)):
            if math.isfinite(val):
                self._loss_seen[name] = True
            elif not math.isnan(val) or self._loss_seen[name]:
                # Inf always flags; NaN only once the signal has been live
                alerts.append(HealthAlert(
                    r, "nonfinite_loss", SEV_FATAL, float(val), 0.0,
                    f"{name} is non-finite ({val!r})"))

        # -- warn: loss-ratio window ---------------------------------------
        if c.loss_ratio_max > 0 and math.isfinite(fb.d_loss) \
                and math.isfinite(fb.g_loss) and fb.d_loss > 0 \
                and fb.g_loss > 0:
            ratio = max(fb.d_loss / fb.g_loss, fb.g_loss / fb.d_loss)
            if ratio > c.loss_ratio_max:
                alerts.append(HealthAlert(
                    r, "loss_ratio", SEV_WARN, ratio, c.loss_ratio_max,
                    f"D/G loss ratio {ratio:.2f} exceeds "
                    f"{c.loss_ratio_max:.2f} (mode-collapse heuristic)"))

        # -- warn: update-norm spike vs window median ----------------------
        if params is not None and update_base is not None:
            norm = float(_tree_update_l2(params, update_base))
            window = self._update_norms[-c.window:]
            if len(window) >= c.min_history and math.isfinite(norm):
                med = _median(window)
                if med > 0 and norm > c.update_norm_factor * med:
                    alerts.append(HealthAlert(
                        r, "update_norm", SEV_WARN, norm,
                        c.update_norm_factor * med,
                        f"global update norm {norm:.4g} is "
                        f"{norm / med:.1f}x the window median {med:.4g}"))
            if math.isfinite(norm):
                self._update_norms.append(norm)

        # -- warn: codec-error spike vs window median ----------------------
        if not math.isnan(fb.codec_error):
            window = self._codec_errors[-c.window:]
            if len(window) >= c.min_history:
                med = _median(window)
                if med > 0 and fb.codec_error > c.codec_error_factor * med:
                    alerts.append(HealthAlert(
                        r, "codec_error_spike", SEV_WARN, fb.codec_error,
                        c.codec_error_factor * med,
                        f"codec error {fb.codec_error:.4g} is "
                        f"{fb.codec_error / med:.1f}x the window median"))
            self._codec_errors.append(fb.codec_error)

        # -- fatal (non-recoverable): epsilon overspend --------------------
        if c.epsilon_budget > 0 and not math.isnan(fb.dp_epsilon) \
                and fb.dp_epsilon > c.epsilon_budget:
            alerts.append(HealthAlert(
                r, "epsilon_overspend", SEV_FATAL, fb.dp_epsilon,
                c.epsilon_budget,
                f"cumulative epsilon {fb.dp_epsilon:.4g} exceeds budget "
                f"{c.epsilon_budget:.4g}", recoverable=False))

        # -- warn: straggler-rate runaway over a full window ---------------
        rate = (fb.stragglers / fb.num_clients) if fb.num_clients else 0.0
        self._straggler_hot.append(rate > c.straggler_rate_max)
        window = self._straggler_hot[-c.window:]
        if len(window) >= max(c.min_history, c.window) and all(window):
            alerts.append(HealthAlert(
                r, "straggler_runaway", SEV_WARN, rate,
                c.straggler_rate_max,
                f"straggler rate above {c.straggler_rate_max:.0%} for "
                f"{len(window)} consecutive rounds"))

        return alerts


def worst(alerts: Sequence[HealthAlert]) -> Optional[HealthAlert]:
    """The most severe alert (fatal beats warn; ties keep first)."""
    if not alerts:
        return None
    return max(alerts, key=lambda a: (a.severity == SEV_FATAL,
                                      -alerts.index(a)))
