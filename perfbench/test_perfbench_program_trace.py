"""The readers of the program's own spans (``perfbench/program_trace.py``
and the metrics that read it) on the CPU: a synthetic session whose steps
place spans through the port's ``span``, CUDA events timed on the host,
and a profile of made-up device operations launched inside the spans."""
import contextlib
import sys
import time
import types
import warnings

import pytest
import torch

from perfbench import common, program_trace
from repro_torch.obs.trace import SYNC_WARNING, span

NEW = {  # name: (unit, source, layer, moves, cell)
    "client_wait_ms.gan": ("ms", "program_span",
                           "client program (fed/programs.py)", "round_s",
                           "dcgan-mnist.plain"),
    "client_wait_ms.gan.private": ("ms", "program_span",
                                   "client program (fed/programs.py)",
                                   "round_s.private", "dcgan-mnist.dp_split"),
    "g_update_ms.gan": ("ms", "program_span",
                        "server G update (core/gan.py)", "round_s",
                        "dcgan-mnist.plain"),
    "g_update_ms.gan.private": ("ms", "program_span",
                                "server G update (core/gan.py)",
                                "round_s.private", "dcgan-mnist.dp_split"),
    "host_syncs.gan": ("syncs", "program_counter",
                       "round's host dispatch (core/gan.py, fed/)",
                       "round_s", "dcgan-mnist.plain"),
    "host_syncs.gan.private": ("syncs", "program_counter",
                               "round's host dispatch (core/gan.py, fed/)",
                               "round_s.private", "dcgan-mnist.dp_split"),
    "accum_ms.lm": ("ms", "program_span", "LM train step (runtime/train.py)",
                    "train_tok_s", "olmoe-1b-7b.train_4k"),
}
KERNEL_NS = 1_000_000       # each made-up device operation runs 1 ms


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class Session:
    """A round of spans: two launches and a sync in ``client``, one launch
    in ``g_update``; ``launched`` logs each launch's system-clock time."""

    unit = "round"
    traffic = {"trace_steps": 2}

    def __init__(self):
        self.steps = 0
        self.launched = []

    def step(self):
        with span("round", index=self.steps):
            with span("engine"), span("client"):
                for _ in range(2):
                    self.launched.append(time.time_ns())
                    time.sleep(0.002)
                warnings.warn(SYNC_WARNING)
            with span("g_update"):
                self.launched.append(time.time_ns())
                time.sleep(0.001)
        self.steps += 1
        return True


@pytest.fixture
def card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def _fake_launches(sess):
    @contextlib.contextmanager
    def launches():
        out = {"ops": [], "unmatched": 0}
        first = len(sess.launched)
        yield out
        out["ops"] = [(t, t + 10_000, t + 10_000 + KERNEL_NS, "k")
                      for t in sess.launched[first:]]
    return launches


def test_charge_picks_the_innermost_open_span():
    spans = [(0, 0, 100), (1, 10, 50), (2, 20, 30), (3, 60, 90)]
    assert program_trace.charge(spans, [5, 10, 25, 40, 55, 70, 100, 120]) \
        == [0, 1, 2, 1, 0, 3, 0, None]


def test_summary_of_a_synthetic_session(card, monkeypatch):
    sess = Session()
    monkeypatch.setattr(program_trace, "launches", _fake_launches(sess))
    ctx = {"trace": {}, "session": sess}
    got = program_trace.read(ctx)
    assert sess.steps == 4                   # two timed, two profiled
    assert program_trace.read(ctx) is got and sess.steps == 4
    spans = got["spans"]
    assert set(spans) == {"round", "engine", "client", "g_update"}
    assert got["unit"] == "round" and got["syncs_by_step"] == [1, 1]
    assert spans["client"]["syncs"] == 1 and spans["round"]["syncs"] == 0
    assert spans["client"]["kernels"] == 2
    assert spans["g_update"]["kernels"] == 1
    assert spans["round"]["kernels"] == 0 and got["uncharged"] == 0
    # busy unions: the operations launched inside a span, children included
    assert spans["client"]["busy_ms"] == pytest.approx(2.0)
    assert spans["round"]["busy_ms"] == pytest.approx(3.0)
    assert spans["client"]["extent_ms"] >= 4.0
    assert spans["client"]["extent_ms"] <= spans["round"]["extent_ms"]
    read = {name: common.reader(name)(ctx) for name in NEW}
    assert read["client_wait_ms.gan"] == read["client_wait_ms.gan.private"] \
        == pytest.approx(spans["client"]["extent_ms"] - 2.0)
    assert read["g_update_ms.gan"] == spans["g_update"]["extent_ms"] >= 1.0
    assert read["host_syncs.gan"] == read["host_syncs.gan.private"] == 1.0
    assert read["accum_ms.lm"] is None       # a round, not an LM step


def test_readers_give_none_without_the_programs_spans(card, monkeypatch):
    """Untraced runs, and a program whose tracer has no ``tracing`` (an
    older tree): no value, and no step is run."""
    sess = Session()
    for name in NEW:
        assert common.reader(name)({"trace": None, "session": sess}) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs.trace",
                        types.ModuleType("repro_torch.obs.trace"))
    ctx = {"trace": {}, "session": sess}
    for name in NEW:
        assert common.reader(name)(ctx) is None
    assert sess.steps == 0


def test_new_per_layer_entries():
    entries = {m["name"]: m for m in common.benchmark()["per_layer"]}
    layers = {m["layer"] for m in entries.values() if m["name"] not in NEW}
    for name, (unit, source, layer, moves, cell) in NEW.items():
        m = entries[name]
        assert (m["unit"], m["source"], m["layer"], m["moves"],
                m["workloads"], m["better"]) == (unit, source, layer, moves,
                                                 [cell], "lower")
        assert callable(common.reader(name))
    assert "client program (fed/programs.py)" in layers
    assert "LM train step (runtime/train.py)" in layers
