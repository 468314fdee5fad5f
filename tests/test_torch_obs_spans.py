"""The program's host spans and host-sync counts (``repro_torch/obs/trace.py``
``span`` / ``tracing``): nesting and round indices, the no-op when no
tracer is active, the spans the FSL-GAN round (both backends) and the LM
train step emit, training bit for bit with a tracer on, and the wall clock
shared with ``torch.profiler``; on the card (``gpu``), device extents and
the count of a ``float()`` of a CUDA tensor.

No JAX here: the ``gpu`` tests of this file run on the card's machine.
"""
import json
import time
import warnings

import pytest
import torch
from _torch_fixtures import cuda, one_thread  # noqa: F401

from repro_torch.config import reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.data import partition_dirichlet, synthetic_lm_batch, \
    synthetic_mnist
from repro_torch.models import transformer as T
from repro_torch.obs import tree_digest
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import SYNC_WARNING, Tracer, span, tracing
from repro_torch.optim import make_optimizer
from repro_torch.runtime import make_train_step

SMALL = {"shape.global_batch": 8, "fsl.num_clients": 2,
         "model.dcgan.base_filters": 8}
GAN_TREE = {"engine": "round", "commit": "round", "g_update": "round",
            "feedback": "round", "client": "engine", "uplink": "engine",
            "reduce": "engine", "sample": "client", "group": "client",
            "batch": "group"}
LM_TREE = {"microbatch": "step", "accumulate": "step", "optim": "step"}


@pytest.fixture(scope="module")
def parts():
    imgs, labels = synthetic_mnist(80, seed=0)
    return partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)


def _check_tree(tracer, tree, root):
    """Every span's parent is the one ``tree`` names (``root`` has none),
    lies inside it on the wall clock and shares its index."""
    by_id = {s.span_id: s for s in tracer.spans}
    for s in tracer.spans:
        assert s.cat == "host" and s.has_wall and not s.has_virtual
        if s.name == root:
            assert s.parent_id is None
            continue
        p = by_id[s.parent_id]
        assert p.name == tree[s.name], (s.name, p.name)
        assert p.wall_start <= s.wall_start <= s.wall_end <= p.wall_end
        assert s.index == p.index


def _names(tracer):
    out = {}
    for s in tracer.spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def test_spans_nest_share_the_round_index_and_lie_inside_parents():
    tr = Tracer("t")
    with tracing(tr):
        for r in (4, 5):
            with span("round", index=r):
                with span("client", client="c0"):
                    with span("batch"):
                        pass
                with span("g_update"):
                    pass
    _check_tree(tr, {"client": "round", "batch": "client",
                     "g_update": "round"}, "round")
    assert sorted(s.index for s in tr.spans) == [4] * 4 + [5] * 4
    client = next(s for s in tr.spans if s.name == "client")
    assert client.args == {"client": "c0"}


def test_span_without_tracer_records_nothing_and_reads_no_clock(
        monkeypatch):
    def boom(*a, **k):
        raise AssertionError("read a clock or made a CUDA event")
    monkeypatch.setattr(obs_trace.time, "time_ns", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert obs_trace._ACTIVE is None
    a, b = span("round", index=1), span("batch")
    assert a is b
    with a:
        with b:
            pass


def test_tracing_restores_the_previous_tracer():
    outer, inner = Tracer("o"), Tracer("i")
    with tracing(outer):
        with tracing(inner):
            with span("a"):
                pass
        with span("b"):
            pass
    assert obs_trace._ACTIVE is None
    assert [s.name for s in inner.spans] == ["a"]
    assert [s.name for s in outer.spans] == ["b"]


def test_syncs_are_charged_to_the_innermost_open_span():
    tr = Tracer("t")
    with tracing(tr, count_syncs=True):
        warnings.warn(SYNC_WARNING)
        with span("round", index=0):
            with span("sample"):
                for _ in range(3):
                    warnings.warn(SYNC_WARNING + " (Triggered internally)")
            warnings.warn(SYNC_WARNING)
            with pytest.warns(UserWarning, match="not a sync"):
                warnings.warn("not a sync")
    got = {s.name: s.syncs for s in tr.spans}
    assert got == {"sample": 3, "round": 1} and tr.syncs_outside == 1
    wall = [e for e in tr.to_chrome("wall")["traceEvents"] if e["ph"] == "X"]
    assert {e["name"]: e["args"]["syncs"] for e in wall} == got


def test_wall_clock_is_the_profilers(tmp_path):
    """A CPU op profiled inside a span falls inside the span's host
    interval, on the trace's ``baseTimeNanoseconds`` + its ``ts``."""
    tr = Tracer("t")
    a = torch.randn(64, 64)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tracing(tr), span("mm"):
            torch.mm(a, a)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    mm = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    assert mm
    s0, s1 = tr.wall_ns(tr.spans[0])
    for e in mm:
        assert s0 <= base + e["ts"] * 1e3
        assert base + (e["ts"] + e["dur"]) * 1e3 <= s1
    x = next(e for e in tr.to_chrome("wall")["traceEvents"]
             if e["ph"] == "X")
    assert x["ts"] == s0 / 1e3 and abs(x["ts"] - time.time_ns() / 1e3) < 6e7


# ---------------------------------------------------------------------------
# spans the program places
# ---------------------------------------------------------------------------

def _gan(parts, **over):
    cfg = get_config("dcgan-mnist").override({**SMALL, **over})
    return FSLGANTrainer(cfg, parts, seed=0, device="cpu")


@pytest.mark.parametrize("backend", ["vectorized", "loop"])
def test_gan_round_emits_the_program_spans(parts, backend):
    """round > engine > client > sample / group > batch, uplink and reduce
    under engine, commit, g_update and feedback under round; every span of
    a round carries its index; and training is bit for bit the untraced
    trainer's."""
    over = {"fed.backend": backend, "fed.codec": "int8",
            "fed.server_reduce": "stream"}
    traced, plain = _gan(parts, **over), _gan(parts, **over)
    tr = Tracer("t")
    hist = {True: [], False: []}
    for r in range(2):
        with tracing(tr):
            hist[True].append(traced.train_epoch(batches_per_client=2))
        hist[False].append(plain.train_epoch(batches_per_client=2))
    assert hist[True] == hist[False]
    assert tree_digest((traced.state.d_params, traced.state.g_params)) == \
        tree_digest((plain.state.d_params, plain.state.g_params))
    _check_tree(tr, GAN_TREE, "round")
    got = _names(tr)
    groups = 1 if backend == "vectorized" else 2
    assert got == {"round": 2, "engine": 2, "client": 2, "sample": 4,
                   "group": 2 * groups, "batch": 4 * groups, "uplink": 4,
                   "reduce": 2 * 4, "commit": 2, "g_update": 2,
                   "feedback": 2}
    assert sorted({s.index for s in tr.spans}) == [0, 1]
    assert tr.syncs_outside == 0


def test_lm_step_emits_microbatch_accumulate_optim():
    cfg = reduce_for_smoke(get_config("qwen3-14b", "train_4k"), seq_len=16,
                           batch=4)
    cfg = cfg.override({"parallel.microbatches": 2, "optim.warmup_steps": 0,
                        "optim.schedule": "constant"})
    m = cfg.model
    params = T.lm_init(0, m, device="cpu")
    opt = make_optimizer(cfg.optim).init(params)
    batch = {k: torch.as_tensor(v) for k, v in
             synthetic_lm_batch(4, 16, m.vocab_size, seed=0).items()}
    step = make_train_step(cfg)
    p0, o0, m0 = step(params, opt, batch, 7)
    tr = Tracer("t")
    with tracing(tr):
        p1, o1, m1 = step(params, opt, batch, 7)
    _check_tree(tr, LM_TREE, "step")
    assert _names(tr) == {"step": 1, "microbatch": 2, "accumulate": 4,
                          "optim": 1}
    assert {s.index for s in tr.spans} == {7}
    assert torch.equal(m0["loss"], m1["loss"])
    assert tree_digest(p0) == tree_digest(p1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_device_extents_nest_on_gpu(cuda):
    x = torch.randn(2048, 2048, device=cuda)
    tr = Tracer("t")
    with tracing(tr, device_events=True):
        with span("outer", index=0):
            with span("inner"):
                for _ in range(20):
                    x = x @ x / 2048
    ms = tr.device_ms()
    by = {s.name: ms[s.span_id] for s in tr.spans}
    assert 0 < by["inner"] <= by["outer"]
    assert by["inner"] > 0.05      # 20 fp32 products of 2048^3


@pytest.mark.gpu
def test_float_of_a_cuda_tensor_counts_one_sync_on_gpu(cuda):
    x = torch.randn(16, device=cuda)
    before = torch.cuda.get_sync_debug_mode()
    tr = Tracer("t")
    with tracing(tr, count_syncs=True):
        with span("round", index=0):
            y = x * 2
            with span("read"):
                float(y.sum())
    assert torch.cuda.get_sync_debug_mode() == before
    assert {s.name: s.syncs for s in tr.spans} == {"read": 1, "round": 0}


@pytest.mark.gpu
def test_gan_round_on_gpu_counts_its_syncs_and_extents(cuda, parts):
    cfg = get_config("dcgan-mnist").override(SMALL)
    trainer = FSLGANTrainer(cfg, parts, seed=0, device=cuda)
    trainer.train_epoch(batches_per_client=2)
    tr = Tracer("t")
    with tracing(tr, device_events=True, count_syncs=True):
        trainer.train_epoch(batches_per_client=2)
    _check_tree(tr, GAN_TREE, "round")
    ms = tr.device_ms()
    assert set(ms) == {s.span_id for s in tr.spans}
    by = {s.name: s for s in tr.spans}
    assert ms[by["client"].span_id] <= ms[by["round"].span_id]
    syncs = {s.name: s.syncs for s in tr.spans}
    # each sampled batch copies its real images and its z to the card
    assert sum(s.syncs for s in tr.spans if s.name == "sample") >= 2 * 2 * 2
    assert syncs["g_update"] >= 2          # a float(loss) a G step
