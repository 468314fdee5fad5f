"""Bench regression gating: compare fresh ``BENCH_*.json`` output against
the committed baselines, noise-aware, and fail loudly on regression.
A copy of ``repro/obs/regress.py`` (plain Python: JSON, git and a rule
table, nothing of JAX or of the card).

    python -m repro_torch.obs.regress --bench-dir benchmarks --baseline-git HEAD

re-reads the fresh files, pulls the committed baselines out of git, and
evaluates a per-metric rule table (:data:`RULES`): each rule gives a
wildcard path, a direction (``lower`` / ``higher`` is better, ``equal``
must match within tolerance, ``true`` must stay truthy) and a relative
tolerance.  Wall-clock rules are flagged ``noisy`` and get a separate,
CLI-overridable tolerance (``--noisy-rel-tol``), because shared CPUs
jitter 2x without meaning anything.

The table names the JAX benchmarks' committed files
(``benchmarks/BENCH_*.json``), which this gate reads and never writes;
the port's own benchmark files get their rules with the port's benchmark.

Two safety valves keep the gate honest rather than brittle:

  * **config gate** — when the fresh file's ``config`` block differs from
    the baseline's (a different bench shape or client count), value rules
    are *skipped* (the numbers aren't comparable) while boolean rules
    still apply (an acceptance property must hold at any size);
  * **missing paths** — a value rule matching nothing is reported but
    only a missing *boolean* gate fails (deleting ``replay_ok`` from the
    bench is itself a regression).

Exit status is nonzero iff any rule fails; ``--report`` writes the
markdown table.
"""
from __future__ import annotations

import fnmatch
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# rule table
# ---------------------------------------------------------------------------

DIR_LOWER = "lower"     # lower is better: fresh <= base * (1 + tol)
DIR_HIGHER = "higher"   # higher is better: fresh >= base * (1 - tol)
DIR_EQUAL = "equal"     # must match: |fresh - base| <= tol * max(|base|,1e-12)
DIR_TRUE = "true"       # boolean acceptance gate: fresh must stay truthy


@dataclass(frozen=True)
class Rule:
    """One metric's regression contract."""
    path: str               # '/'-joined wildcard path into the JSON
    direction: str          # lower | higher | equal | true
    rel_tol: float = 0.0
    noisy: bool = False     # wall-clock: tolerance overridable via CLI


RULES: Dict[str, Tuple[Rule, ...]] = {
    "BENCH_control.json": (
        # acceptance booleans — must hold at any bench size
        Rule("codec/frontier_ok", DIR_TRUE),
        Rule("codec/adaptive_bytes_le_best_static", DIR_TRUE),
        Rule("codec/adaptive_error_ok", DIR_TRUE),
        Rule("codec/adaptive/replay_ok", DIR_TRUE),
        Rule("sigma/budget_ok", DIR_TRUE),
        Rule("deadline/faster", DIR_TRUE),
        # deterministic trajectory values (virtual clock / priced wire)
        Rule("codec/adaptive/up_bytes", DIR_LOWER, 0.01),
        Rule("codec/static/*/up_bytes", DIR_EQUAL, 0.01),
        Rule("sigma/adaptive_epsilon", DIR_LOWER, 0.01),
        Rule("deadline/adaptive_round_s", DIR_LOWER, 0.05),
    ),
    "BENCH_fed_runtime.json": (
        Rule("codecs/*/up_mbytes", DIR_LOWER, 0.01),
        Rule("codecs/*/down_mbytes", DIR_EQUAL, 0.01),
        Rule("codecs/*/round_time_s", DIR_EQUAL, 0.01),
        Rule("scheduling/*/round_time_s", DIR_EQUAL, 0.01),
        Rule("scheduling/*/trace_spans", DIR_EQUAL, 0.0),
        Rule("scheduling/*/stragglers", DIR_EQUAL, 0.0),
        # pipelined split execution: acceptance gates hold at any size;
        # virtual round times are deterministic (priced LAN model)
        Rule("pipeline/speedup_ok", DIR_TRUE),
        Rule("pipeline/numerics_ok", DIR_TRUE),
        Rule("pipeline/boundary_fuse/fused_matches", DIR_TRUE),
        Rule("pipeline/k*/round_time_s", DIR_EQUAL, 0.01),
        # population scale: acceptance gates (size-independent booleans),
        # deterministic roster resampling, and the analytic byte/epsilon
        # model — all exact; roster sampling wall-clock is noisy
        Rule("scale/analytic_wan_cut_ok", DIR_TRUE),
        Rule("scale/deterministic", DIR_TRUE),
        Rule("scale/epsilon_monotone_ok", DIR_TRUE),
        Rule("scale/hier_round/wan_cut_ok", DIR_TRUE),
        Rule("scale/hier_round/wan_up_bytes_hier", DIR_LOWER, 0.01),
        Rule("scale/hier_round/wan_cut", DIR_HIGHER, 0.01),
        Rule("scale/populations/*/wan_bytes_flat", DIR_EQUAL, 0.0),
        Rule("scale/populations/*/wan_bytes_hier", DIR_EQUAL, 0.0),
        Rule("scale/populations/*/amplified_epsilon_100r",
             DIR_LOWER, 0.01),
        Rule("scale/populations/*/rounds_per_s_hier", DIR_HIGHER, 0.01),
        # compressed-domain streaming aggregation: numerics + speedup are
        # acceptance gates at any size; wire bytes and peak live decoded
        # tree counts are deterministic (exact); timings are wall-clock
        Rule("agg/c*/numerics_ok", DIR_TRUE),
        Rule("agg/c64/speedup_ok", DIR_TRUE),
        Rule("agg/c*/wire_bytes", DIR_EQUAL, 0.0),
        Rule("agg/c*/peak_trees_decode", DIR_EQUAL, 0.0),
        Rule("agg/c*/peak_trees_stream", DIR_EQUAL, 0.0),
        # wall-clock: shared CPUs jitter wildly — wide default, overridable
        Rule("agg/c*/*_us", DIR_LOWER, 1.0, noisy=True),
        Rule("dispatch/*_us", DIR_LOWER, 1.0, noisy=True),
        Rule("codecs/*/us_per_epoch", DIR_LOWER, 1.0, noisy=True),
        Rule("scheduling/*/us_per_epoch", DIR_LOWER, 1.0, noisy=True),
        Rule("pipeline/k*/us_per_epoch", DIR_LOWER, 1.0, noisy=True),
        Rule("pipeline/boundary_fuse/*_us", DIR_LOWER, 1.0, noisy=True),
        Rule("scale/populations/*/sample_us", DIR_LOWER, 1.0, noisy=True),
        Rule("scale/sharded/*_us", DIR_LOWER, 1.0, noisy=True),
    ),
    "BENCH_privacy.json": (
        # deterministic fixed-prefix probes
        Rule("split_depth_dcor/*", DIR_EQUAL, 0.10),
        Rule("strategy_boundaries/*/min_depth", DIR_EQUAL, 0.0),
        Rule("strategy_boundaries/*/mean_depth", DIR_EQUAL, 0.0),
    ),
}


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

@dataclass
class Check:
    """One evaluated (rule, path) pair."""
    file: str
    path: str
    rule: Rule
    baseline: Any = None
    fresh: Any = None
    status: str = "pass"    # pass | fail | skip | missing
    note: str = ""

    @property
    def failed(self) -> bool:
        return self.status == "fail"


def _flatten(obj: Any, prefix: str = "") -> Dict[str, Any]:
    """Scalar leaves of a JSON tree as '/'-joined paths (list entries
    indexed numerically)."""
    out: Dict[str, Any] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = obj
    return out


def _match(rule: Rule, paths) -> List[str]:
    return sorted(p for p in paths if fnmatch.fnmatchcase(p, rule.path))


def _num(x: Any) -> Optional[float]:
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return None
    return float(x)


def _eval_one(rule: Rule, base: Any, fresh: Any, tol: float) -> Tuple[str, str]:
    """-> (status, note) for one matched path."""
    if rule.direction == DIR_TRUE:
        return ("pass", "") if fresh else ("fail", "gate is falsy")
    b, f = _num(base), _num(fresh)
    if b is None or f is None:
        return "skip", "non-numeric"
    if math.isnan(b) and math.isnan(f):
        return "pass", "both NaN"
    if math.isinf(b) and math.isinf(f) and (b > 0) == (f > 0):
        return "pass", "both infinite"       # e.g. epsilon with no DP
    if rule.direction == DIR_LOWER:
        ok = f <= b * (1.0 + tol) + 1e-12
        return ("pass", "") if ok else (
            "fail", f"{f:.6g} > baseline {b:.6g} (+{tol:.0%})")
    if rule.direction == DIR_HIGHER:
        ok = f >= b * (1.0 - tol) - 1e-12
        return ("pass", "") if ok else (
            "fail", f"{f:.6g} < baseline {b:.6g} (-{tol:.0%})")
    # equal
    ok = abs(f - b) <= tol * max(abs(b), 1e-12)
    return ("pass", "") if ok else (
        "fail", f"{f:.6g} != baseline {b:.6g} (tol {tol:.0%})")


def evaluate(fresh: Dict[str, Any], baseline: Dict[str, Any],
             rules: Tuple[Rule, ...], *, file: str = "",
             noisy_rel_tol: Optional[float] = None) -> List[Check]:
    """Run one file's rule table.  When the two ``config`` blocks differ
    the numbers aren't comparable — value rules are skipped, boolean
    gates still apply (the config gate; see module docstring)."""
    fb, bb = _flatten(fresh), _flatten(baseline)
    cfg_differs = fresh.get("config") != baseline.get("config")
    checks: List[Check] = []
    for rule in rules:
        tol = rule.rel_tol
        if rule.noisy and noisy_rel_tol is not None:
            tol = noisy_rel_tol
        matched = _match(rule, set(fb) | set(bb))
        if not matched:
            status = "fail" if rule.direction == DIR_TRUE else "missing"
            checks.append(Check(file, rule.path, rule, status=status,
                                note="no matching paths"))
            continue
        for p in matched:
            c = Check(file, p, rule, baseline=bb.get(p), fresh=fb.get(p))
            if p not in fb or p not in bb:
                missing = "fresh" if p not in fb else "baseline"
                c.status = ("fail" if rule.direction == DIR_TRUE
                            else "missing")
                c.note = f"path absent in {missing}"
            elif cfg_differs and rule.direction != DIR_TRUE:
                c.status, c.note = "skip", "config blocks differ"
            else:
                c.status, c.note = _eval_one(rule, bb[p], fb[p], tol)
            checks.append(c)
    return checks


# ---------------------------------------------------------------------------
# baseline sources + report
# ---------------------------------------------------------------------------

def git_baseline(bench_dir: str, name: str, ref: str
                 ) -> Optional[Dict[str, Any]]:
    """The committed version of ``<bench_dir>/<name>`` at ``ref`` (None:
    not in git at that ref)."""
    try:
        out = subprocess.run(
            ["git", "-C", bench_dir, "show", f"{ref}:./{name}"],
            capture_output=True, text=True, check=True).stdout
        return json.loads(out)
    except (subprocess.CalledProcessError, json.JSONDecodeError,
            FileNotFoundError):
        return None


def run_gate(bench_dir: str, *, baseline_git: Optional[str] = None,
             noisy_rel_tol: Optional[float] = None) -> List[Check]:
    """Evaluate every known bench file present in ``bench_dir``.

    ``baseline_git=None`` compares each file against itself — trivially
    green on an unmodified tree, which makes the local no-op invocation a
    self-test of the rule table.  After a bench run has overwritten the
    files, ``baseline_git='HEAD'`` gates them against the committed ones.
    """
    checks: List[Check] = []
    for name, rules in sorted(RULES.items()):
        path = os.path.join(bench_dir, name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            fresh = json.load(f)
        if baseline_git is None:
            baseline = fresh
        else:
            baseline = git_baseline(bench_dir, name, baseline_git)
            if baseline is None:
                checks.append(Check(name, "<file>", Rule(name, DIR_EQUAL),
                                    status="missing",
                                    note=f"no baseline at {baseline_git}"))
                continue
        checks.extend(evaluate(fresh, baseline, rules, file=name,
                               noisy_rel_tol=noisy_rel_tol))
    return checks


def markdown_report(checks: List[Check]) -> str:
    failed = [c for c in checks if c.failed]
    lines = ["# Bench regression report", "",
             f"**{'REGRESSION' if failed else 'PASS'}** — "
             f"{len(failed)} failed / {len(checks)} checks", ""]
    lines += ["| file | path | direction | baseline | fresh | status |",
              "|---|---|---|---|---|---|"]
    # failures first, then everything else
    for c in sorted(checks, key=lambda c: (not c.failed, c.file, c.path)):
        mark = {"pass": "ok", "fail": "**FAIL**", "skip": "skip",
                "missing": "missing"}[c.status]
        note = f" ({c.note})" if c.note and c.status != "pass" else ""
        lines.append(f"| {c.file} | `{c.path}` | {c.rule.direction} "
                     f"| {c.baseline!r} | {c.fresh!r} | {mark}{note} |")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="gate fresh BENCH_*.json output against committed "
                    "baselines")
    p.add_argument("--bench-dir", default="benchmarks",
                   help="directory holding BENCH_*.json (default: "
                        "benchmarks)")
    p.add_argument("--baseline-git", default=None, metavar="REF",
                   help="take baselines from this git ref (e.g. HEAD); "
                        "default compares files to themselves (rule-table "
                        "self-test)")
    p.add_argument("--noisy-rel-tol", type=float, default=None,
                   help="override the tolerance of noisy (wall-clock) "
                        "rules, e.g. 2.0 on shared CPUs")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="write the markdown report here")
    args = p.parse_args(argv)

    checks = run_gate(args.bench_dir, baseline_git=args.baseline_git,
                      noisy_rel_tol=args.noisy_rel_tol)
    report = markdown_report(checks)
    if args.report:
        with open(args.report, "w") as f:
            f.write(report)
    print(report)
    if not checks:
        print("no bench files found — nothing gated", file=sys.stderr)
        return 2
    return 1 if any(c.failed for c in checks) else 0


if __name__ == "__main__":
    raise SystemExit(main())
