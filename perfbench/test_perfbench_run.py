"""The harness end to end on the CPU (the card stubbed, the cells cut to a
tiny size): the last line's schema, the refusal without a card, and that
nothing the harness loads is JAX or the JAX package."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import common, run
from perfbench import trace as tr
from perfbench.conftest import shrink

ROOT = common.ROOT
_real_profiled = tr.profiled


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _cpu_profiled():
    """``trace.profiled`` with the CPU's operators standing in for the
    device's kernels (a CPU build of PyTorch traces no CUDA)."""
    return _real_profiled(activities=("CPU",), cats=("cpu_op",))


@pytest.fixture
def stub_card(monkeypatch):
    for name, fn in {"is_available": lambda: True,
                     "device_count": lambda: 1,
                     "synchronize": lambda *a: None,
                     "set_device": lambda *a: None,
                     "max_memory_allocated": lambda *a: 123,
                     "get_device_name": lambda *a: "stub",
                     "empty_cache": lambda: None}.items():
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    real_resolve, real_driver = common.resolve_cell, common.driver
    monkeypatch.setattr(common, "resolve_cell",
                        lambda name: shrink(real_resolve(name)))

    def driver(name):
        mod = real_driver(name)

        class Session(mod.Session):
            def __init__(self, spec, seed, device, **kw):
                super().__init__(spec, seed, "cpu", **kw)
        return type("Driver", (), {"Session": Session})
    monkeypatch.setattr(common, "driver", driver)
    monkeypatch.setattr(tr, "profiled", _cpu_profiled)
    # a test process may hold JAX from other test files; the check itself
    # runs in test_harness_loads_no_jax and test_loaded_jax_is_refused
    real_forbidden = run.forbidden_modules
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    return real_forbidden


def _last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["dcgan-mnist.dp_split",
                                  "olmoe-1b-7b.train_4k"])
def test_last_line_schema(cell, trace, stub_card, capsys):
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 99),
                   "--seconds", "0.5", "--trace", str(trace)])
    assert rc == 0
    got = _last_line(capsys)
    assert list(got)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(got)
    assert got["correct"] is True and got["failed"] == 0
    spec = common.resolve_cell(cell)
    want = {m["name"] for m in (spec["layer"] if trace else spec["e2e"])}
    want.discard("roofline.dp_clip")       # no dp_clip kernel on the CPU
    assert want <= set(got["metrics"])
    for m in got["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    dev = got["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 123
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert set(got["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(got["breakdown"]["device_ops"]) <= 10
    for c in got["checks"].values():
        assert set(c) == {"value", "limit"}


def test_loaded_jax_is_refused(stub_card, monkeypatch, capsys):
    import types
    monkeypatch.setattr(run, "forbidden_modules", stub_card)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "dcgan-mnist.plain", "--seed", "3",
                   "--seconds", "0.2", "--trace", "0"])
    captured = capsys.readouterr()
    assert rc == 3 and "{" not in captured.out
    assert "jax" in captured.err


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "dcgan-mnist.plain", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


def test_harness_loads_no_jax():
    """Everything ``run.py`` imports and loads by name, in a fresh
    process: no top-level module named jax, jaxlib, flax or repro."""
    code = (
        "import sys, runpy\n"
        "sys.argv = ['perfbench/run.py', '--help']\n"
        "try:\n"
        "    runpy.run_path('perfbench/run.py', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "from perfbench import common, faults, calibrate, flops\n"
        "bench = common.benchmark()\n"
        "for c in bench['configs']:\n"
        "    cfg = common.load_json(common.ROOT / c['file'])\n"
        "    common.driver(cfg['driver']); common.reference(c['name'])\n"
        "for w in bench['workloads']:\n"
        "    common.generator(common.resolve_cell(w['name'])['traffic']\n"
        "                     ['generator'])\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    common.reader(m['name'])\n"
        "import repro_torch.core.gan, repro_torch.runtime.train\n"
        "import repro_torch.fed.programs, repro_torch.models.transformer\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(out.stdout.split())
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & set(common.FORBIDDEN_MODULES), \
        loaded & set(common.FORBIDDEN_MODULES)


@pytest.mark.gpu
def test_cell_runs_correct_on_the_card(cuda):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "dcgan-mnist.plain",
         "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"], got["checks"]
    assert got["device"]["count"] == 1 and got["attempted"] > 0
