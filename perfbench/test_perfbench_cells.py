"""Cells resolve from files by name, and BENCHMARK.json keeps to its
contract's shape."""
import json
import re

import pytest

from perfbench import common

BENCH = common.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    spec = common.resolve_cell(cell)
    assert spec["cell"]["name"] == cell
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["name"] == spec["cell"]["traffic"]
    assert set(spec["limits"]) <= {"loss", "loss1", "loss_first", "grad1",
                                   "grad1_diff", "grad1_diff_med", "change3",
                                   "diff1", "diff1_med"}
    drv = common.driver(spec["config"]["driver"])
    assert hasattr(drv, "Session")
    assert hasattr(common.reference(spec["config"]["name"]), "run")
    names = {m["name"] for m in spec["e2e"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["layer"], "every cell reports a per-layer metric"
    for m in spec["e2e"] + spec["layer"]:
        assert callable(common.reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        common.resolve_cell("no-such.cell")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert NAME.match(c["name"])
        cfg = common.load_json(common.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m.get("workloads", CELLS):
            reported = e2e[m["moves"]].get("workloads", CELLS)
            assert w in reported, (m["name"], w)


def test_subseeds_differ_and_repeat():
    big = 2**31 + 17
    assert common.subseed(big, 1) == common.subseed(big, 1)
    assert common.subseed(big, 1) != common.subseed(big, 2)
    assert common.subseed(big, 1) != common.subseed(big + 1, 1)


def test_key_arithmetic_is_the_ports():
    import torch
    from repro_torch import keys
    key = keys.fold_in(keys.root(keys.DP_SGD, 2**40 + 3), 2, 0, 4, 0, 1)
    assert common.key_seed(key) == keys.seed_of(key)
    assert torch.equal(common.key_normal(key, (5, 7), "cpu"),
                       keys.normal(key, (5, 7), "cpu"))
