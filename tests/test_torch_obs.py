"""The port's flight recorder (``repro_torch/obs``): tracing, metrics,
record + replay, digests and profiling, on the CPU at a small width — the
twins of tests/test_obs.py.

Inside the port, bit for bit: obs-on equals obs-off (losses, round times,
and the digests of the committed state), and the recorded feedback
replayed offline through the controllers reproduces the live knobs.  The
loop and vectorized backends are a tolerance pin in the port (d_loss 1e-5,
parameters 5e-5, tests/test_torch_vectorized.py): their digest sketches
agree to that, and ``diff_runs`` names their first divergence
``numeric``.  Against JAX: ``tree_sketch`` of bridged parameters, to 1e-6
relative (hashes cannot match across frameworks).  On the card
(``gpu``): ``profile_engine_kernels`` launches each of its kernels.
"""
import json
import os
import time

import jax
import numpy as np
import pytest
import torch
from _torch_fixtures import cuda, one_thread  # noqa: F401

from repro.models.dcgan import disc_init as jdisc_init
from repro.obs.digest import tree_sketch as jtree_sketch
from repro.configs.registry import get_config as jget_config
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_config
from repro_torch.control import knobs_from_config
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.obs import (FlightRecorder, JsonlSink, MetricsRegistry,
                             Tracer, diff_runs, feedback_from_dict,
                             feedback_to_dict, knobs_from_dict, knobs_to_dict,
                             load_jsonl, load_run, profile_engine_kernels,
                             replay_decisions, replay_run, state_digest,
                             tree_digest, tree_sketch, validate_chrome_trace)
from repro_torch.obs.replay import suite_from_manifest
from repro_torch.obs.trace import PID_WALL

SMALL = {"shape.global_batch": 8, "fsl.num_clients": 2,
         "model.dcgan.base_filters": 8}
# the reference's loop-vs-vectorized tolerances (tests/test_fed_runtime.py)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-5, atol=5e-5)


def _cfg(**over):
    return get_config("dcgan-mnist").override({**SMALL, **over})


def _trainer(parts, **over):
    return FSLGANTrainer(_cfg(**over), parts, seed=0, device="cpu")


def _obs(out, run_id, **over):
    return {"obs.enabled": True, "obs.out_dir": str(out),
            "obs.run_id": run_id, **over}


@pytest.fixture(scope="module")
def parts():
    imgs, labels = synthetic_mnist(120, seed=0)
    return partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)


@pytest.fixture(scope="module")
def recorded_run(tmp_path_factory, parts):
    """One adaptive split run recorded end to end; shared by the replay,
    trace-schema and span tests."""
    out = tmp_path_factory.mktemp("obs")
    tr = _trainer(parts, **_obs(out, "pin", **{
        "split.enabled": True, "control.mode": "adaptive",
        "control.controllers": ["codec", "deadline"]}))
    for _ in range(3):
        tr.train_epoch(batches_per_client=2)
    tr.recorder.flush()
    return tr, os.path.join(str(out), "pin")


# ---------------------------------------------------------------------------
# tracer unit behavior
# ---------------------------------------------------------------------------

def test_tracer_spans_nest_and_record_parents():
    tr = Tracer("t")
    with tr.span("outer", cat="round"):
        with tr.span("inner", cat="client"):
            pass
    outer = next(s for s in tr.spans if s.name == "outer")
    inner = next(s for s in tr.spans if s.name == "inner")
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert outer.wall_start <= inner.wall_start
    assert inner.wall_end <= outer.wall_end


def test_tracer_virtual_offset_keeps_clock_monotone():
    tr = Tracer("t")
    tr.record("round 0", cat="round", track="server", v_start=0.0, v_end=5.0)
    assert tr.last_virtual_end() == 5.0
    tr.set_virtual_offset(tr.last_virtual_end())
    tr.record("round 1", cat="round", track="server", v_start=0.0, v_end=5.0)
    rounds = sorted(tr.by_cat("round"), key=lambda s: s.v_start)
    assert [(s.v_start, s.v_end) for s in rounds] == [(0.0, 5.0), (5.0, 10.0)]


def test_chrome_trace_export_is_schema_valid(tmp_path):
    tr = Tracer("t")
    parent = tr.record("round 0", cat="round", track="server",
                       v_start=0.0, v_end=2.0,
                       args={"bad": float("nan"), "ok": 1})
    tr.record("up c0", cat="uplink", track="c0", v_start=1.0, v_end=2.0,
              parent=parent)
    obj = tr.to_chrome("virtual")
    assert validate_chrome_trace(obj) == 2
    x = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert all(isinstance(e["args"]["bad"], str) for e in x
               if "bad" in e.get("args", {}))
    path = tmp_path / "trace.json"
    tr.export_chrome(str(path))
    with open(path) as f:
        assert validate_chrome_trace(json.load(f)) == 2


def test_validate_chrome_trace_rejects_malformed():
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": []})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [
            {"name": "x", "ph": "X", "pid": 1, "tid": 1,
             "ts": float("nan"), "dur": 1.0}]})


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_metrics_registry_types_and_conflicts():
    reg = MetricsRegistry()
    c = reg.counter("wire.up_bytes")
    c.inc(10)
    c.inc(5)
    assert c.value == 15
    with pytest.raises(ValueError):
        c.inc(-1)
    reg.gauge("fed.round_time_s").set(2.5)
    h = reg.histogram("fed.client_finish_s")
    for v in (1.0, 2.0, 4.0):
        h.observe(v)
    assert h.count == 3 and h.mean == pytest.approx(7.0 / 3.0)
    assert h.quantile(0.0) <= h.quantile(1.0)
    with pytest.raises(TypeError):
        reg.gauge("wire.up_bytes")
    assert reg.snapshot()["wire.up_bytes"]["value"] == 15
    assert "fed.client_finish_s" in reg


def test_jsonl_sink_round_trips(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with JsonlSink(path) as sink:
        sink.write({"a": 1})
        sink.write({"b": [1.5, 2.5]})
    assert load_jsonl(path) == [{"a": 1}, {"b": [1.5, 2.5]}]


# ---------------------------------------------------------------------------
# record + replay
# ---------------------------------------------------------------------------

def test_knobs_serialization_round_trips_bit_exactly():
    k = knobs_from_config(_cfg(**{"split.enabled": True}))
    k2 = k.replace(codec="int8", deadline_s=12.345678901234567,
                   stage_by_boundary={0: "dp", 1: "int8"})
    back = knobs_from_dict(json.loads(json.dumps(knobs_to_dict(k2))))
    assert back == k2
    assert all(isinstance(b, int) for b in back.stage_by_boundary)


def test_feedback_serialization_round_trips(recorded_run):
    tr, _ = recorded_run
    for fb in tr.feedback:
        back = feedback_from_dict(json.loads(json.dumps(feedback_to_dict(fb))))
        assert (json.dumps(feedback_to_dict(back), sort_keys=True)
                == json.dumps(feedback_to_dict(fb), sort_keys=True))
        assert back.round_index == fb.round_index
        assert back.client_finish_s == fb.client_finish_s


def test_recorded_run_writes_all_artifacts(recorded_run):
    _, run_dir = recorded_run
    for name in ("manifest.json", "feedback.jsonl", "knobs.jsonl",
                 "metrics.jsonl", "trace.json"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    rec = load_run(run_dir)
    assert rec.num_rounds == 3 and len(rec.knobs) == 3
    assert rec.manifest["config"]["control"]["mode"] == "adaptive"


def test_replay_reproduces_live_knob_decisions_bit_exactly(recorded_run):
    tr, run_dir = recorded_run
    res = replay_run(run_dir)
    assert res.matches, res.diff()
    assert len(res.decisions) == 3
    for dec, rec in zip(res.decisions, load_run(run_dir).knobs):
        assert dec == rec
    # the controllers steered: the codec walked from its probe
    assert [k.codec for k in res.decisions][0] == "topk"


def test_replay_decisions_is_the_controller_fold(recorded_run):
    tr, run_dir = recorded_run
    rec = load_run(run_dir)
    decisions = replay_decisions(suite_from_manifest(rec.manifest),
                                 rec.feedback, knobs_from_config(tr.cfg))
    assert decisions == rec.knobs


def test_replay_requires_manifest(tmp_path):
    with pytest.raises(FileNotFoundError):
        replay_run(str(tmp_path / "nope"))


# ---------------------------------------------------------------------------
# engine spans
# ---------------------------------------------------------------------------

def test_split_round_traces_every_boundary_crossing(recorded_run):
    tr, _ = recorded_run
    spans = tr.recorder.tracer.spans
    assert {"round", "downlink", "client", "batch", "segment", "boundary",
            "uplink", "aggregate"} <= {s.cat for s in spans}
    hops = [s for s in spans if s.cat == "boundary"]
    batches = [s for s in spans if s.cat == "batch"]
    per_batch = {cid: 2 * ex.num_boundaries
                 for cid, ex in tr.split_execs.items()}
    expect = sum(per_batch[s.track] for s in batches)
    assert expect > 0 and len(hops) == expect
    for h in hops:
        assert {"boundary", "direction"} <= set(h.args)


def test_spans_nest_on_the_virtual_clock(recorded_run):
    tr, _ = recorded_run
    tracer = tr.recorder.tracer
    tol = 1e-6
    for s in tracer.spans:
        if s.parent_id is None or not s.has_virtual:
            continue
        p = tracer.by_id(s.parent_id)
        if not p.has_virtual:
            continue
        assert p.v_start - tol <= s.v_start, (p.name, s.name)
        assert s.v_end <= p.v_end + tol, (p.name, s.name)


def test_round_spans_monotone_across_epochs(recorded_run):
    tr, _ = recorded_run
    rounds = sorted(tr.recorder.tracer.by_cat("round"),
                    key=lambda s: s.v_start)
    assert len(rounds) == 3
    for a, b in zip(rounds, rounds[1:]):
        assert a.v_end <= b.v_start + 1e-9
    assert rounds[-1].v_end == pytest.approx(tr.feedback[-1].clock_s)


@pytest.mark.parametrize("over", [
    {"fed.mode": "fedasync"},
    {"fed.hierarchy_cohorts": 2, "fed.server_reduce": "stream",
     "fed.codec": "int8"}], ids=["fedasync", "hierarchy"])
def test_async_and_hierarchy_engines_emit_spans(tmp_path, parts, over):
    tr = _trainer(parts, **_obs(tmp_path, "a", **over))
    tr.train_epoch(batches_per_client=2)
    cats = {s.cat for s in tr.recorder.tracer.spans}
    assert {"round", "downlink", "client", "uplink", "aggregate"} <= cats
    assert ("cohort" in cats) == ("fed.hierarchy_cohorts" in over)
    tr.recorder.flush()
    with open(os.path.join(str(tmp_path), "a", "trace.json")) as f:
        assert validate_chrome_trace(json.load(f)) > 0


# ---------------------------------------------------------------------------
# obs never steers
# ---------------------------------------------------------------------------

def test_obs_on_is_bit_exact_with_obs_off(tmp_path, parts):
    """Off, on, and on with the wall spans (``trace_clock="both"``: the
    recorder's tracer active for each round) train the same bits."""
    losses, finals = {}, {}
    for on in (None, "virtual", "both"):
        over = {} if on is None else _obs(tmp_path, f"x-{on}",
                                           **{"obs.trace_clock": on})
        tr = _trainer(parts, **{"split.enabled": True, **over})
        hist = []
        for _ in range(2):
            m = tr.train_epoch(batches_per_client=2)
            hist.append((m["d_loss"], m["g_loss"], m["round_time_s"]))
        losses[on] = hist
        finals[on] = tree_digest((tr.state.d_params, tr.state.g_params))
        if on == "both":
            assert {"round", "client", "g_update"} <= {
                s.name for s in tr.recorder.tracer.spans if s.has_wall}
    assert losses[None] == losses["virtual"] == losses["both"]
    assert finals[None] == finals["virtual"] == finals["both"]


def test_recorder_exports_the_program_wall_spans(tmp_path, parts):
    """``trace_clock="both"``: trace.json holds wall-pid events of the
    program's round, client and g_update spans with absolute system-clock
    timestamps (one round each, the engine's virtual spans nested under
    them), and passes the schema check."""
    t0 = time.time_ns()
    tr = _trainer(parts, **_obs(tmp_path, "w", **{"obs.trace_clock": "both"}))
    tr.train_epoch(batches_per_client=2)
    t1 = time.time_ns()
    with open(tr.recorder.flush()) as f:
        obj = json.load(f)
    assert validate_chrome_trace(obj) > 0
    wall = [e for e in obj["traceEvents"]
            if e["ph"] == "X" and e["pid"] == PID_WALL]
    by_name = {}
    for e in wall:
        by_name.setdefault(e["name"], []).append(e)
        assert t0 / 1e3 <= e["ts"] <= e["ts"] + e["dur"] <= t1 / 1e3
        assert e["args"]["index"] == 0 and e["args"]["syncs"] == 0
    for name in ("round", "client", "g_update"):
        assert len(by_name[name]) == 1, name
    tracer = tr.recorder.tracer
    engine = next(s for s in tracer.spans if s.name == "engine")
    virtual = [s for s in tracer.spans if s.has_virtual]
    assert virtual and all(s.parent_id is not None for s in virtual
                           if s.cat == "round")
    assert {tracer.by_id(s.parent_id).name for s in virtual
            if s.cat == "round"} == {engine.name}


def test_profiling_gated_off_by_default(recorded_run):
    _, run_dir = recorded_run
    assert not os.path.exists(os.path.join(run_dir, "profile.json"))


def test_profiling_writes_roofline_terms_when_enabled(tmp_path, parts):
    tr = _trainer(parts, **_obs(tmp_path, "p", **{
        "obs.profile_kernels": True, "privacy.enabled": True,
        "privacy.mode": "dp_sgd", "fed.codec": "int8",
        "split.boundary_stage": "int8+dp"}))
    tr.train_epoch(batches_per_client=1)
    with open(os.path.join(str(tmp_path), "p", "profile.json")) as f:
        prof = json.load(f)
    kinds = sorted(n.split("_")[0] for n in prof)
    assert kinds == ["agg", "boundary", "dp", "fedavg"]
    for p in prof.values():
        assert p["compile_s"] > 0 and p["run_s"] > 0 and p["lower_s"] == 0
        assert p["flops"] > 0 and p["compute_term_s"] > 0
        assert p["bound_s"] == max(p["compute_term_s"], p["memory_term_s"])
        assert p["device"] == "cpu" and not p["kernel"]


# ---------------------------------------------------------------------------
# flush idempotence
# ---------------------------------------------------------------------------

def test_flush_is_idempotent(recorded_run):
    tr, run_dir = recorded_run
    rec = tr.recorder
    path = rec.flush()
    assert path == os.path.join(run_dir, "trace.json")
    mtime = os.path.getmtime(path)
    with open(path) as f:
        before = f.read()
    os.utime(path, (mtime - 10, mtime - 10))
    assert rec.flush() == path
    assert os.path.getmtime(path) == pytest.approx(mtime - 10)
    with open(path) as f:
        assert f.read() == before
    rec.tracer.record("probe", cat="round", track="server",
                      v_start=0.0, v_end=0.0)
    assert rec.flush() == path
    assert os.path.getmtime(path) > mtime - 10


# ---------------------------------------------------------------------------
# digests: artifact-level bit-exactness pins
# ---------------------------------------------------------------------------

def _state_digest(tr):
    st = tr.state
    return state_digest(st.d_params[tr._active_clients()[0]], st.d_opt,
                        st.g_params, st.g_opt, round_index=st.step - 1)


def test_recorded_run_writes_digests_and_alert_sink(recorded_run):
    _, run_dir = recorded_run
    rec = load_run(run_dir)
    assert [d.round_index for d in rec.digests] == [0, 1, 2]
    for d in rec.digests:
        assert len(d.global_digest) == 32 and len(d.opt_digest) == 32
        assert not d.rolled_back and d.global_sketch[0] > 0
        assert d.aggregated_digest == d.global_digest


def test_digests_obs_on_matches_obs_off_state(tmp_path, parts):
    tr_on = _trainer(parts, **_obs(tmp_path, "don"))
    tr_off = _trainer(parts)
    off = []
    for _ in range(2):
        tr_on.train_epoch(batches_per_client=2)
        tr_off.train_epoch(batches_per_client=2)
        off.append(_state_digest(tr_off))
    rec = load_run(os.path.join(str(tmp_path), "don"))
    for f in ("global_digest", "opt_digest", "gan_digest", "global_sketch"):
        assert [getattr(d, f) for d in rec.digests] \
            == [getattr(d, f) for d in off], f


def test_digests_loop_vs_vectorized_backend(tmp_path, parts):
    """Loop and vectorized dispatch are a tolerance pin in the port: the
    committed sketches agree to the parameter tolerance, the losses to
    the loss tolerance, and diff_runs classifies the digest mismatch as a
    numeric divergence at equal knobs."""
    dirs = {}
    for backend in ("loop", "vectorized"):
        tr = _trainer(parts, **_obs(tmp_path, f"b_{backend}",
                                    **{"fed.backend": backend}))
        for _ in range(2):
            tr.train_epoch(batches_per_client=2)
        dirs[backend] = os.path.join(str(tmp_path), f"b_{backend}")
    ra, rb = load_run(dirs["loop"]), load_run(dirs["vectorized"])
    for da, db in zip(ra.digests, rb.digests):
        np.testing.assert_allclose(da.global_sketch[:3], db.global_sketch[:3],
                                   **PARAM_TOL)
        assert da.global_sketch[3] == db.global_sketch[3]
    for fa, fb in zip(ra.feedback, rb.feedback):
        np.testing.assert_allclose(fa.d_loss, fb.d_loss, **LOSS_TOL)
    d = diff_runs(dirs["loop"], dirs["vectorized"])
    fd = d.first_divergence
    assert fd is not None and fd.kind == "numeric"
    assert fd.field.startswith("digest.")
    assert not any(e.kind == "controller" for e in d.entries)


def test_tree_sketch_of_bridged_params_matches_jax():
    """Hashes cannot match across frameworks; the sketch does: the JAX
    init's D bridged into the port sketches to 1e-6 relative."""
    c = jget_config("dcgan-mnist").override(SMALL).model.dcgan
    tree = jax.tree.map(np.asarray, jdisc_init(jax.random.PRNGKey(3), c))
    got = tree_sketch(params_from_numpy(tree, "cpu"))
    want = jtree_sketch(tree)
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-6)
    assert got[3] == want[3]


def test_tree_digest_sees_every_bit():
    a = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "s": torch.zeros((), dtype=torch.int32)}
    b = {"w": a["w"].clone(), "s": a["s"].clone()}
    assert tree_digest(a) == tree_digest(b)
    b["w"][1, 2] = torch.nextafter(b["w"][1, 2], torch.tensor(10.0))
    assert tree_digest(a) != tree_digest(b)
    assert tree_digest(a) != tree_digest({"v": a["w"], "s": a["s"]})


# ---------------------------------------------------------------------------
# config surface
# ---------------------------------------------------------------------------

def test_obs_section_validates_names_at_construction():
    from repro_torch.config import ObsConfig
    with pytest.raises(ValueError):
        ObsConfig(trace_clock="sundial")
    with pytest.raises(ValueError):
        ObsConfig(sinks=("trace", "punchcard"))
    cfg = _cfg(**{"obs.enabled": True, "obs.sinks": ["trace"]})
    assert cfg.obs.sinks == ("trace",)
    assert cfg.to_dict()["obs"]["enabled"] is True


def test_recorder_from_config_names_its_run_dir(tmp_path):
    rec = FlightRecorder.from_config(_cfg(**_obs(tmp_path, "named")))
    assert rec.run_dir == os.path.join(str(tmp_path), "named")
    assert rec.wants("digests") and os.path.isdir(rec.run_dir)
    rec.close()


# ---------------------------------------------------------------------------
# the card (gpu)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_profile_engine_kernels_launches_each_kernel_on_gpu(cuda):
    """On the card each profile launches its hand-written kernel: the
    first call and each timed one (``runs``), and nothing else."""
    from repro_torch.kernels.agg_fuse.kernel import \
        dequant_reduce_leaves_kernel
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
    from repro_torch.kernels.fedavg.kernel import fedavg_leaves_kernel
    kernels = {"fedavg": fedavg_leaves_kernel, "dp": dp_clip_noise_kernel,
               "boundary": boundary_fuse_kernel,
               "agg": dequant_reduce_leaves_kernel}
    cfg = _cfg(**{"privacy.enabled": True, "privacy.mode": "dp_sgd",
                  "privacy.use_kernel": True, "split.use_kernel": True,
                  "split.boundary_stage": "int8+dp", "fed.codec": "int8",
                  "fed.kernel_aggregation": True})
    before = {k: w.launches for k, w in kernels.items()}
    prof = profile_engine_kernels(cfg, device=cuda, runs=2)
    torch.cuda.synchronize()
    assert {n.split("_")[0] for n in prof} == set(kernels)
    for name, p in prof.items():
        k = name.split("_")[0]
        assert p["kernel"] and p["device"].startswith("cuda")
        assert kernels[k].launches - before[k] == 1 + p["runs"] == 3, name
        assert 0 < p["run_s"] and p["bound_s"] > 0
