"""The port's slice as a whole held against the JAX package on the CPU:
``FSLGANTrainer.train_epoch`` through the federation engine (sync, loop
backend, identity codec, ``fed.kernel_aggregation``; the privacy and split
options; the stream and batched server reduce, the edge hierarchy and the
async modes), plus the planning, engine and entry-point contracts around
it.

Both trainers start from the same parameters (the JAX init, bridged) and
draw the same host stream (``np.random.default_rng(seed)``).  The JAX
trainer runs its fedavg Pallas kernel in interpret mode, the port its
plain version.
"""
import os
import subprocess
import sys
from dataclasses import astuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401
from _torch_parity import BN_FED_BIASES, close_to_reference
from _torch_parity import paths as _paths

from repro.configs.registry import get_config as jget_config
from repro.core.devices import make_pool as jmake_pool
from repro.core.gan import FSLGANTrainer as JTrainer
from repro.core.selection import plan_all_clients as jplan_all_clients
from repro.core.simulate import plan_epoch_time as jplan_epoch_time
from repro.data import partition_dirichlet, synthetic_mnist
from repro.fed.engine import ClientSpec as JClientSpec
from repro.fed.engine import FederationEngine as JEngine
from repro.fed.events import BernoulliAvailability as JBernoulli
from repro.fed.transport import apply_delta as japply_delta
from repro.fed.transport import delta_tree as jdelta_tree
from repro.fed.transport import tree_bytes as jtree_bytes
from repro.models.dcgan import disc_layer_costs, disc_layer_names
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_config
from repro_torch.core.devices import make_pool
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.core.selection import STRATEGIES, plan_all_clients
from repro_torch.core.simulate import plan_epoch_time
from repro_torch.fed.engine import ClientSpec, FederationEngine
from repro_torch.fed.events import BernoulliAvailability
from repro_torch.fed.transport import apply_delta, delta_tree, tree_bytes
from repro_torch.tree import leaves

ROUNDS, BATCHES = 2, 2
SMALL = {"shape.global_batch": 8, "fsl.num_clients": 2,
         "model.dcgan.base_filters": 8}
# the JAX kernel runs as the JAX tests run it; the port ignores the flag
KERNEL = {"fed.kernel_aggregation": True, "fed.kernel_interpret": True}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def parts():
    imgs, labels = synthetic_mnist(120, seed=0)
    return partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)


@pytest.fixture(scope="module")
def jax_run(parts):
    """The JAX trainer's run, once per module (it compiles for ~20 s):
    initial params, per-round metrics, final params — all numpy."""
    tr = JTrainer(jget_config("dcgan-mnist").override({**SMALL, **KERNEL}),
                  parts, seed=0)
    cid0 = tr.client_ids[0]
    init = (_np(tr.state.g_params), _np(tr.state.d_params[cid0]))
    metrics = [tr.train_epoch(batches_per_client=BATCHES)
               for _ in range(ROUNDS)]
    final = (_np(tr.state.g_params),
             {cid: _np(d) for cid, d in tr.state.d_params.items()})
    return init, metrics, final


def _port_trainer(parts, over, init=None):
    tr = FSLGANTrainer(get_config("dcgan-mnist").override(over), parts,
                       seed=0, device="cpu")
    if init is not None:
        g, d = init
        tr.state.g_params = params_from_numpy(g, tr.device)
        tr.state.d_params = {cid: params_from_numpy(d, tr.device)
                             for cid in tr.client_ids}
    return tr


def test_train_epoch_matches_jax(parts, jax_run):
    init, jmetrics, (jg, jd) = jax_run
    tr = _port_trainer(parts, {**SMALL, **KERNEL}, init)
    metrics = [tr.train_epoch(batches_per_client=BATCHES)
               for _ in range(ROUNDS)]
    for m, jm in zip(metrics, jmetrics):
        assert set(m) == set(jm)
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4)
        for k in ("round_time_s", "clock_s", "up_mbytes", "down_mbytes",
                  "num_clients", "stragglers", "mean_staleness",
                  "codec_error"):
            assert m[k] == jm[k], k
    drift = tr.cfg.optim.lr * ROUNDS * BATCHES    # Adam steps per tree
    g0, d0 = init
    for got, want, start in ([(tr.state.g_params, jg, g0)]
                             + [(tr.state.d_params[cid], jd[cid], d0)
                                for cid in tr.client_ids]):
        for path, g, w, s in zip(_paths(got), leaves(got),
                                 jax.tree.leaves(want),
                                 jax.tree.leaves(start)):
            if path[-2:] in BN_FED_BIASES:
                for side in (g.numpy(), w):
                    np.testing.assert_allclose(side, s, rtol=0, atol=drift,
                                               err_msg=str(path))
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4,
                                           err_msg=str(path))


# The slice's privacy and split options.  Noise is off (the port's noise
# streams are not JAX's), the clips bind: DP-SGD's per-example gradient
# norms at this size exceed 0.1 (test_torch_privacy.py checks it), and a
# 2-step round delta's norm exceeds 0.01.
PRIVATE_AND_SPLIT = {
    "dp_sgd": {"privacy.enabled": True, "privacy.mode": "dp_sgd",
               "privacy.clip_norm": 0.1, "privacy.noise_multiplier": 0.0},
    "uplink_int8": {"privacy.enabled": True, "privacy.mode": "uplink",
                    "privacy.clip_norm": 0.01,
                    "privacy.noise_multiplier": 0.0, "fed.codec": "int8"},
    "split_int8_dp": {"split.enabled": True,
                      "split.boundary_stage": "int8+dp",
                      "split.stage_sigma": 0.0},
    # 4 micro-batches of 2 a batch, through the fused int8+dp stage
    "split_pipelined": {"split.enabled": True,
                        "split.boundary_stage": "int8+dp",
                        "split.stage_sigma": 0.0,
                        "split.pipeline_microbatches": 4},
    # DP-SGD through the split: the per-example staged step through the
    # fused clip stage (its codec-free form), then dp_clip
    "dp_sgd_split": {"privacy.enabled": True, "privacy.mode": "dp_sgd",
                     "privacy.clip_norm": 0.1,
                     "privacy.noise_multiplier": 0.0,
                     "split.enabled": True, "split.boundary_stage": "dp",
                     "split.stage_sigma": 0.0},
}


@pytest.mark.parametrize("case", sorted(PRIVATE_AND_SPLIT))
def test_private_and_split_rounds_match_jax(parts, case):
    """``train_epoch`` under DP-SGD, uplink DP with the int8 codec, and the
    executed split with the fused int8+dp stage, against the JAX trainer
    (loop backend) from the same parameters: losses at 1e-4 relative,
    parameters at 1e-4 absolute (BN-fed biases to their drift bound),
    bytes, times and epsilon exactly.  The codec error is a relative L2
    error of int8 rounding, so a rounding that flips between frameworks
    moves it in the 3rd digit; it is held to 1e-2 relative."""
    over = {**SMALL, **KERNEL, **PRIVATE_AND_SPLIT[case]}
    jtr = JTrainer(jget_config("dcgan-mnist").override(over), parts, seed=0)
    cid0 = jtr.client_ids[0]
    init = (_np(jtr.state.g_params), _np(jtr.state.d_params[cid0]))
    tr = _port_trainer(parts, over, init)
    if case.startswith("split"):
        assert any(ex.num_boundaries >= 1 for ex in tr.split_execs.values())
    for _ in range(ROUNDS):
        jm = jtr.train_epoch(batches_per_client=BATCHES)
        m = tr.train_epoch(batches_per_client=BATCHES)
        assert set(m) == set(jm)
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(m["codec_error"], jm["codec_error"],
                                   rtol=1e-2, atol=1e-12)
        for k in set(m) - {"d_loss", "g_loss", "codec_error"}:
            assert m[k] == jm[k], k
    drift = tr.cfg.optim.lr * ROUNDS * BATCHES
    g0, d0 = init
    for got, want, start in (
            (tr.state.g_params, _np(jtr.state.g_params), g0),
            (tr.state.d_params[cid0], _np(jtr.state.d_params[cid0]), d0)):
        for path, g, w, s in zip(_paths(got), leaves(got),
                                 jax.tree.leaves(want),
                                 jax.tree.leaves(start)):
            if path[-2:] in BN_FED_BIASES:
                for side in (g.numpy(), w):
                    np.testing.assert_allclose(side, s, rtol=0, atol=drift,
                                               err_msg=str(path))
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4,
                                           err_msg=str(path))


def test_dp_sgd_split_int8_round_matches_jax(parts):
    """One round of DP-SGD through the split with the fused int8+dp stage
    (noise off) against the JAX trainer, both with SGD (no momentum, no
    clip) so that each parameter's change over the round is lr times its
    summed privatized gradients: a gradient of the wrong size moves it in
    proportion, where Adam's update would not.  Each example crosses
    alone, so an int8 quantum that flips between frameworks moves that
    example's gradient by up to one quantum, 1/127 of the leaf's largest
    (test_torch_privacy.py's test_per_example_split_grads_match_jax says
    why), and the clip and the mean over examples only shrink it.  So:
    the losses at 1e-4 relative; every leaf's change within 1/127 of its
    largest change, the BN-fed biases (whose gradient is rounding noise)
    within 1/127 of the tree's largest change, plus 4 ulp of the leaf's
    largest parameter (the read-back's rounding)."""
    over = {**SMALL, **KERNEL, **PRIVATE_AND_SPLIT["dp_sgd_split"],
            "split.boundary_stage": "int8+dp", "optim.name": "sgd",
            "optim.beta1": 0.0, "optim.grad_clip": 0.0}
    jtr = JTrainer(jget_config("dcgan-mnist").override(over), parts, seed=0)
    cid0 = jtr.client_ids[0]
    init = (_np(jtr.state.g_params), _np(jtr.state.d_params[cid0]))
    tr = _port_trainer(parts, over, init)
    jm = jtr.train_epoch(batches_per_client=BATCHES)
    m = tr.train_epoch(batches_per_client=BATCHES)
    assert set(m) == set(jm)
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
    for k in set(m) - {"d_loss", "g_loss"}:
        assert m[k] == jm[k], k
    g0, d0 = init
    for got, want, start in (
            (tr.state.g_params, _np(jtr.state.g_params), g0),
            (tr.state.d_params[cid0], _np(jtr.state.d_params[cid0]), d0)):
        starts = jax.tree.leaves(start)
        moved = [s - w for s, w in zip(starts, jax.tree.leaves(want))]
        top = max(float(np.abs(w).max()) for w in moved)
        assert top > 0.0
        for path, g, w, s in zip(_paths(got), leaves(got), moved, starts):
            scale = top if path[-2:] in BN_FED_BIASES else np.abs(w).max()
            np.testing.assert_allclose(
                s - g.numpy(), w, rtol=0, err_msg=str(path),
                atol=scale / 127 + 4 * np.spacing(np.abs(s).max()))


# The compressed-domain server reduce, the edge hierarchy and the async
# engine.  hier: 2 clients in 2 cohorts of 1; async: fedasync with each
# client cycling twice.
TOPOLOGIES = {"flat": {}, "hier": {"fed.hierarchy_cohorts": 2},
              "async": {"fed.mode": "fedasync", "fed.async_cycles": 2}}


def _close_to_reference(tr, got, want, start, noise_steps=False):
    """``_torch_parity.close_to_reference`` over this module's rounds."""
    close_to_reference(got, want, start, tr.cfg.optim.lr * ROUNDS * BATCHES,
                       noise_steps)


@pytest.mark.parametrize("codec", ["none", "fp16", "int8"])
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_stream_rounds_match_jax(parts, topo, codec):
    """``fed.server_reduce="stream"`` rounds against the JAX trainer's same
    rounds from the same parameters (its agg_fuse kernels in interpret
    mode): losses at 1e-4 relative, D to the parity rule, G to that rule
    with rounding-level Adam steps allowed (``_close_to_reference``),
    bytes, times and staleness exactly, the codec error at 1e-2 relative
    (an int8 rounding that flips between frameworks moves it in the 3rd
    digit)."""
    over = {**SMALL, **KERNEL, **TOPOLOGIES[topo], "fed.codec": codec,
            "fed.server_reduce": "stream"}
    jtr = JTrainer(jget_config("dcgan-mnist").override(over), parts, seed=0)
    cid0 = jtr.client_ids[0]
    init = (_np(jtr.state.g_params), _np(jtr.state.d_params[cid0]))
    tr = _port_trainer(parts, over, init)
    for _ in range(ROUNDS):
        jm = jtr.train_epoch(batches_per_client=BATCHES)
        m = tr.train_epoch(batches_per_client=BATCHES)
        assert set(m) == set(jm)
        assert ("edge_mbytes" in m) == (topo == "hier")
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(m["codec_error"], jm["codec_error"],
                                   rtol=1e-2, atol=1e-12)
        for k in set(m) - {"d_loss", "g_loss", "codec_error"}:
            assert m[k] == jm[k], k
        assert tr.engine.last_report.peak_live_trees == \
            jtr.engine.last_report.peak_live_trees
    g0, d0 = init
    _close_to_reference(tr, tr.state.g_params, _np(jtr.state.g_params), g0,
                        noise_steps=True)
    _close_to_reference(tr, tr.state.d_params[cid0],
                        _np(jtr.state.d_params[cid0]), d0)


@pytest.fixture(scope="module")
def parts3():
    imgs, labels = synthetic_mnist(180, seed=0)
    return partition_dirichlet(imgs, labels, 3, alpha=0.5, seed=0)


def _one_round(parts3, over):
    tr = _port_trainer(parts3, {**SMALL, "fsl.num_clients": 3,
                                "fed.kernel_aggregation": True, **over})
    return tr, tr.train_epoch(batches_per_client=2)


@pytest.mark.parametrize("codec", ["none", "fp16", "int8", "topk"])
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_stream_and_batched_rounds_match_decode(parts3, topo, codec):
    """Inside the port, one round per server reduce from the same start:
    the aggregated D within 2e-5 of the decode round's (the reference's
    own pin, tests/test_agg_stream.py), wire bytes equal exactly."""
    over = {**TOPOLOGIES[topo], "fed.codec": codec}
    ta, ma = _one_round(parts3, over)
    for reduce in ("stream", "batched"):
        tb, mb = _one_round(parts3, {**over, "fed.server_reduce": reduce})
        for a, b in zip(leaves(ta.state.d_params["c0"]),
                        leaves(tb.state.d_params["c0"])):
            assert float((a - b).abs().max()) <= 2e-5, reduce
        assert ma["up_mbytes"] == mb["up_mbytes"]
        assert ma.get("edge_mbytes") == mb.get("edge_mbytes")
        if codec != "none":
            assert mb["codec_error"] == pytest.approx(
                ma["codec_error"], rel=1e-3, abs=1e-6)


@pytest.mark.parametrize("over, peak", [
    ({}, 3), ({"fed.server_reduce": "stream"}, 1),
    ({"fed.server_reduce": "batched"}, 1),
    ({"fed.hierarchy_cohorts": 2, "fed.server_reduce": "stream"}, 3),
    ({"fed.hierarchy_cohorts": 2}, 5),
])
def test_peak_live_trees_match_reference(parts3, over, peak):
    """The reference's numbers (tests/test_agg_stream.py): decode stages
    one decoded tree per landed client (3), the compressed-domain reduce
    only its accumulator (1); under the hierarchy the stream reduce holds
    the 2 cohort aggregates and one accumulator (3), decode the 3 landed
    trees and the 2 reductions (5)."""
    tr, _ = _one_round(parts3, {"fed.codec": "int8", **over})
    assert tr.engine.last_report.peak_live_trees == peak


def test_engine_sync_equals_sequential_bit_for_bit(parts):
    """The port's twin of tests/test_fed_runtime.py's pin: with the host
    FedAvg, the engine round is the sequential loop, bit for bit."""
    ta = _port_trainer(parts, SMALL)
    tb = _port_trainer(parts, SMALL)
    for _ in range(ROUNDS):
        ma = ta.train_epoch(batches_per_client=BATCHES)
        mb = tb.train_epoch_sequential(batches_per_client=BATCHES)
        for k in ("d_loss", "g_loss", "num_clients"):
            assert ma[k] == mb[k]
    for cid in ta.state.d_params:
        for a, b in zip(leaves(ta.state.d_params[cid]),
                        leaves(tb.state.d_params[cid])):
            assert torch.equal(a, b)
    for a, b in zip(leaves(ta.state.g_params), leaves(tb.state.g_params)):
        assert torch.equal(a, b)


def test_generate_gives_images(parts):
    out = _port_trainer(parts, SMALL).generate(5, seed=1)
    assert out.shape == (5, 28, 28, 1) and np.all(np.abs(out) <= 1.0)


# ---------------------------------------------------------------------------
# planning and the engine against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("preset", ["paper", "uniform"])
def test_plans_and_prices_match_reference(strategy, preset):
    cfg = jget_config("dcgan-mnist").model.dcgan
    costs = disc_layer_costs(cfg)
    layers = [(n, costs[n]) for n in disc_layer_names(cfg)]
    for seed in range(3):
        jpool = jmake_pool(preset, 5, 4, seed)
        pool = make_pool(preset, 5, 4, seed)
        assert [astuple(c) for c in pool] == [astuple(c) for c in jpool]
        jplans = jplan_all_clients(jpool, layers, strategy, seed)
        plans = plan_all_clients(pool, layers, strategy, seed)
        assert list(plans) == list(jplans)
        for (cid, p), cl, jcl in zip(plans.items(), pool, jpool):
            assert astuple(p) == astuple(jplans[cid])
            assert plan_epoch_time(p, cl, 3, 0.05) == \
                jplan_epoch_time(jplans[cid], jcl, 3, 0.05)


def test_engine_round_matches_reference_with_deadline_and_churn():
    """Scheduling alone (a bare callable as the program): availability
    churn, the straggler deadline, link pricing and byte accounting."""
    fed = {"fed.deadline_s": 3.0, "fed.availability": 0.7,
           "fed.availability_seed": 3}
    tree = {"w": np.ones((64, 32), np.float32),
            "b": {"x": np.zeros(17, np.float32)}}
    times = [0.5, 1.0, 2.9, 0.1, 2.0]
    jeng = JEngine(jget_config("dcgan-mnist").override(fed).fed,
                   [JClientSpec(f"c{i}", 10.0 + i, t)
                    for i, t in enumerate(times)])
    eng = FederationEngine(get_config("dcgan-mnist").override(fed).fed,
                           [ClientSpec(f"c{i}", 10.0 + i, t)
                            for i, t in enumerate(times)])
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = params_from_numpy(tree, "cpu")
    for _ in range(4):
        jrep = jeng.run_round(jtree, lambda cid, p: (p, {}),
                              down_bytes=50_000)
        rep = eng.run_round(ttree, lambda cid, p: (p, {}), down_bytes=50_000)
        for k in ("participated", "unavailable", "stragglers",
                  "round_time_s", "clock_s", "finish_s", "codec_error",
                  "version"):
            assert getattr(rep, k) == getattr(jrep, k), k
        assert rep.traffic.up_bytes == jrep.traffic.up_bytes
        assert rep.traffic.down_bytes == jrep.traffic.down_bytes


def test_availability_trace_matches_reference():
    ours, ref = BernoulliAvailability(0.5, 7), JBernoulli(0.5, 7)
    for r in range(20):
        for cid in ("c0", "c1", "c7"):
            assert ours.available(cid, r) == ref.available(cid, r)


def test_transport_helpers_match_reference():
    rng = np.random.default_rng(0)
    a = {"w": rng.standard_normal((5, 3)).astype(np.float32),
         "b": {"x": rng.standard_normal(4).astype(np.float32)}}
    b = jax.tree.map(lambda l: l * 0.5, a)
    assert tree_bytes(params_from_numpy(a, "cpu")) == jtree_bytes(a)
    d = delta_tree(params_from_numpy(a, "cpu"), params_from_numpy(b, "cpu"))
    jd = jdelta_tree(a, b)
    back = apply_delta(params_from_numpy(b, "cpu"), d)
    jback = japply_delta(b, jd)
    for x, y in zip(leaves(d) + leaves(back),
                    jax.tree.leaves(jd) + jax.tree.leaves(jback)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# entry points and isolation
# ---------------------------------------------------------------------------

def test_trainer_runs_on_the_gpu_unless_told_otherwise(parts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FSLGANTrainer(get_config("dcgan-mnist").override(SMALL), parts)


@pytest.mark.parametrize("over", [
    {"fed.mode": "fedasync"}, {"fed.mode": "fedbuff"},
    {"fed.server_reduce": "stream"}, {"fed.hierarchy_cohorts": 2},
    {"split.enabled": True, "split.pipeline_microbatches": 2},
    {"split.enabled": True, "privacy.enabled": True,
     "privacy.mode": "dp_sgd"},
    {"fed.backend": "vectorized"}, {"fed.backend": "auto"},
    {"fed.shard_clients": True},
    {"privacy.enabled": True, "control.mode": "adaptive"},
    {"control.mode": "adaptive"}, {"obs.enabled": True},
    {"obs.health.enabled": True},
])
def test_ported_option_runs_one_round(parts, over, tmp_path):
    """Options ported since the first slice, which used to raise: one CPU
    round each, with finite losses and both clients' updates landed."""
    if over.get("obs.enabled"):
        over = {**over, "obs.out_dir": str(tmp_path)}
    tr = _port_trainer(parts, {**SMALL, **over})
    m = tr.train_epoch(batches_per_client=1)
    assert np.isfinite(m["d_loss"]) and np.isfinite(m["g_loss"])
    assert m["num_clients"] == 2
    assert ("edge_mbytes" in m) == ("fed.hierarchy_cohorts" in over)
    assert ("lan_mbytes" in m) == ("split.enabled" in over)


def test_port_imports_neither_jax_nor_repro():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert len(names) > 20, names\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
