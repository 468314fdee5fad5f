"""head_kernel_share.lm: its benchmark entry, None where the program keeps
no head counters, the share from a session's counters, and one counting
step shared with ``expert_fill.lm`` and ``attn_kernel_share.lm``
(whichever reads first runs it; the others run none of their own)."""
import sys
import types

import pytest

from perfbench import common

LM = ["olmoe-1b-7b.train_4k", "deepseek-v2-lite-16b.train_8k"]


def _session(counters=None, steps=None):
    sess = types.SimpleNamespace(unit="step", traffic={"trace_steps": 2},
                                 program_trace={"unit": "step", "spans": {}})
    if counters is not None:
        sess.expert_counters = counters
    sess.step = (lambda: pytest.fail("ran a step")) if steps is None \
        else (lambda: steps.append(1))
    return sess


def _read(sess, trace=True):
    return common.reader("head_kernel_share.lm")(
        {"trace": {} if trace else None, "session": sess})


def test_entry():
    entries = common.benchmark()["per_layer"]
    entry = {m["name"]: m for m in entries}["head_kernel_share.lm"]
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"],
            entry["moves"], entry["workloads"]) == (
        "%", "higher", "program_counter", "LM head (models/layers.py)",
        "train_tok_s", LM)
    assert entries[-1] is entry          # appended after the accepted ones


@pytest.mark.parametrize("counters,want", [
    ({"head_kernel": 4, "head_plain": 0, "attn_kernel": 20}, 100.0),
    ({"head_kernel": 3, "head_plain": 1}, 75.0),
    ({"head_kernel": 0, "head_plain": 4}, 0.0),
    ({"attn_kernel": 20, "attn_plain": 0, "moe_kept": 5}, None),  # parent's
    (None, None)])                                                # none
def test_share_from_the_sessions_counters(counters, want):
    sess = _session(counters if counters is not None else {})
    if counters is None:
        sess.expert_counters = None
    assert _read(sess) == want


def test_none_untraced_or_without_the_programs_tracer(monkeypatch):
    assert _read(_session({"head_kernel": 4, "head_plain": 0}),
                 trace=False) is None
    sess = _session()
    del sess.program_trace
    monkeypatch.setitem(sys.modules, "repro_torch.obs.trace",
                        types.ModuleType("repro_torch.obs.trace"))
    assert _read(sess) is None


def test_one_counting_step_for_every_counter_reader(monkeypatch):
    """The first of the three readers runs the counting step; the others
    read its counters."""
    steps = []
    sess = _session(steps=steps)
    from repro_torch.obs import trace as program

    def step():
        steps.append(1)
        program.count(head_kernel=4, head_plain=0, attn_kernel=2,
                      attn_plain=2, moe_kept=3, moe_capacity=4)
    sess.step = lambda: _in_step(program, step)
    assert _read(sess) == 100.0
    ctx = {"trace": {}, "session": sess}
    assert common.reader("attn_kernel_share.lm")(ctx) == 50.0
    assert common.reader("expert_fill.lm")(ctx) == 75.0
    assert len(steps) == 1


def _in_step(program, body):
    with program.span("step"):
        body()
