"""The port's bench regression gate (``repro_torch.obs.regress``): twins of
the gate's tests in tests/test_obs_health.py, over the committed
``benchmarks/BENCH_*.json`` (read, never written), and the same checks as
the reference's gate on the same inputs.
"""
import copy
import dataclasses
import json
import os

import pytest

from repro.obs import regress as jregress
from repro_torch.obs import regress as tregress
from repro_torch.obs.regress import (RULES, Rule, evaluate, git_baseline,
                                     main, markdown_report, run_gate)

BENCH_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks")


def _control_bench():
    with open(os.path.join(BENCH_DIR, "BENCH_control.json")) as f:
        return json.load(f)


def _same_checks(got, want):
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]


def test_rule_table_is_the_reference_table():
    assert {k: [dataclasses.astuple(r) for r in v]
            for k, v in RULES.items()} == \
        {k: [dataclasses.astuple(r) for r in v]
         for k, v in jregress.RULES.items()}


def test_regress_rule_table_passes_on_unmodified_tree():
    checks = run_gate(BENCH_DIR)                 # self-compare
    assert checks and not any(c.failed for c in checks)
    assert {c.file for c in checks} == set(RULES)
    _same_checks(checks, jregress.run_gate(BENCH_DIR))


def test_regress_fails_on_degraded_value_metric():
    base = _control_bench()
    fresh = copy.deepcopy(base)
    fresh["codec"]["adaptive"]["up_bytes"] *= 10     # 10x the wire bytes
    checks = evaluate(fresh, base, RULES["BENCH_control.json"],
                      file="BENCH_control.json")
    bad = [c for c in checks if c.failed]
    assert [c.path for c in bad] == ["codec/adaptive/up_bytes"]
    assert "REGRESSION" in markdown_report(checks)
    assert "**FAIL**" in markdown_report(checks)
    want = jregress.evaluate(fresh, base,
                             jregress.RULES["BENCH_control.json"],
                             file="BENCH_control.json")
    _same_checks(checks, want)
    assert markdown_report(checks) == jregress.markdown_report(want)


def test_regress_fails_on_flipped_acceptance_gate():
    base = _control_bench()
    fresh = copy.deepcopy(base)
    fresh["codec"]["frontier_ok"] = False
    checks = evaluate(fresh, base, RULES["BENCH_control.json"],
                      file="BENCH_control.json")
    assert any(c.failed and c.path == "codec/frontier_ok" for c in checks)


def test_regress_config_gate_skips_values_keeps_booleans():
    base = _control_bench()
    fresh = copy.deepcopy(base)
    fresh["config"] = {"different": "shape"}
    fresh["codec"]["adaptive"]["up_bytes"] *= 10     # would fail...
    fresh["codec"]["frontier_ok"] = False
    checks = evaluate(fresh, base, RULES["BENCH_control.json"],
                      file="BENCH_control.json")
    by_path = {c.path: c for c in checks}
    assert by_path["codec/adaptive/up_bytes"].status == "skip"
    assert by_path["codec/frontier_ok"].failed


def test_regress_missing_boolean_gate_is_a_regression():
    base = _control_bench()
    fresh = copy.deepcopy(base)
    del fresh["codec"]["frontier_ok"]            # deleting the gate fails it
    checks = evaluate(fresh, base, RULES["BENCH_control.json"],
                      file="BENCH_control.json")
    gate = next(c for c in checks if c.path == "codec/frontier_ok")
    assert gate.failed and "absent" in gate.note


@pytest.mark.parametrize("base,fresh,status", [
    (float("nan"), float("nan"), "pass"),
    (float("inf"), float("inf"), "pass"),
    (1.0, "text", "skip"),
    (100.0, 100.5, "pass"),
    (100.0, 102.0, "fail")])
def test_regress_value_edges(base, fresh, status):
    rules = (Rule("x/*", "lower", 0.01),)
    got = evaluate({"x": {"a": fresh}}, {"x": {"a": base}}, rules)
    want = jregress.evaluate({"x": {"a": fresh}}, {"x": {"a": base}},
                             (jregress.Rule("x/*", "lower", 0.01),))
    assert [c.status for c in got] == [c.status for c in want] == [status]


def test_regress_noisy_tolerance_is_overridable():
    base = {"dispatch": {"loop_us": 100.0}}
    fresh = {"dispatch": {"loop_us": 250.0}}     # 2.5x slower
    rules = (Rule("dispatch/*_us", "lower", 1.0, noisy=True),)
    assert any(c.failed for c in evaluate(fresh, base, rules))
    assert not any(c.failed for c in evaluate(fresh, base, rules,
                                              noisy_rel_tol=3.0))


def test_regress_git_baseline_reads_committed_file():
    """The committed file at HEAD, as the reference reads it (None in
    both outside a git checkout)."""
    committed = git_baseline(BENCH_DIR, "BENCH_control.json", "HEAD")
    assert committed == jregress.git_baseline(BENCH_DIR,
                                              "BENCH_control.json", "HEAD")
    assert git_baseline(BENCH_DIR, "BENCH_none.json", "HEAD") is None


def test_regress_cli(tmp_path):
    assert main(["--bench-dir", str(tmp_path)]) == 2     # nothing to gate
    report = str(tmp_path / "report.md")
    assert main(["--bench-dir", BENCH_DIR, "--report", report]) == 0
    with open(report) as f:
        text = f.read()
    assert text.startswith("# Bench regression report")
    assert "**PASS**" in text
    assert tregress.DIR_TRUE == jregress.DIR_TRUE == "true"
