"""The port's pipelined split (1F1B over micro-batches) held against the
JAX package on the CPU: the overlap schedule (``core/pipeline``), the
pricing that uses it (``core/simulate``: ``plan_epoch_time`` at K > 1,
``epoch_time_report``, ``strategy_sweep``), the pipelined timeline, and
``SplitExecution.run_pipelined``; plus the in-port pins (K = 1 is ``run``
bit for bit, the step is the mean of the per-micro-batch monolithic
gradients).

Schedules and prices are pure Python with the same float operations in
the same order as the reference: they must be EQUAL.  Gradients are held
to 1e-5 of each leaf's largest magnitude (the two frameworks' convolutions
sum in other orders); through the int8 codec, to 1e-4, since a rounding
that flips between frameworks moves a crossing element by one quantum
(ROADMAP Queue C's rule for lossy stages).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st
from _torch_fixtures import cuda_fp32, one_thread  # noqa: F401

from repro.config import DCGANConfig as JDCGANConfig
from repro.config import SplitConfig as JSplitConfig
from repro.core import pipeline as jpipe
from repro.core import simulate as jsim
from repro.core import split as js
from repro.core.devices import Client as JClient
from repro.core.devices import Device as JDevice
from repro.core.devices import make_pool as jmake_pool
from repro.core.gan import bce_logits as jbce_logits
from repro.core.selection import make_plan as jmake_plan
from repro.models.dcgan import disc_apply_layer as jdisc_apply_layer
from repro.models.dcgan import disc_init as jdisc_init
from repro.models.dcgan import disc_layer_costs, disc_layer_names
from repro_torch import keys
from repro_torch.bridge import params_from_numpy
from repro_torch.config import DCGANConfig, SplitConfig
from repro_torch.core import pipeline as tpipe
from repro_torch.core import simulate as tsim
from repro_torch.core import split as ts
from repro_torch.core.devices import Client, Device, make_pool
from repro_torch.core.gan import bce_logits, d_loss_fn
from repro_torch.core.selection import STRATEGIES, make_plan
from repro_torch.models.dcgan import disc_apply_layer
from repro_torch.tree import leaves, tree_map, value_and_grad

JC, C = JDCGANConfig(base_filters=8), DCGANConfig(base_filters=8)
LAYERS = [(n, c) for n, c in ((n, disc_layer_costs(JC)[n])
                              for n in disc_layer_names(JC))]
BN_FED_BIASES = {("conv1", "b"), ("conv2", "b")}


def _paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]


def _sched_fields(s):
    return (s.num_microbatches, s.devices,
            tuple((t.kind, t.microbatch, t.index, t.device, t.t0, t.t1)
                  for t in s.tasks),
            s.seg_fwd_s, s.seg_bwd_s, s.hop_fwd_s, s.hop_bwd_s,
            s.hop_fwd_full_s, s.hop_bwd_full_s, s.makespan, s.sequential_s,
            s.speedup, s.device_busy_s(), s.segment_work_s())


# ---------------------------------------------------------------------------
# the overlap schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k", [(16, 4), (16, 5), (16, 100), (6, 4),
                                 (7, 4), (1, 8), (0, 8), (256, 4),
                                 (256, 3), (8, 0), (12, -2)])
def test_effective_microbatches_matches_jax(b, k):
    assert tpipe.effective_microbatches(b, k) == \
        jpipe.effective_microbatches(b, k)


def test_k1_schedule_is_the_additive_model_exactly():
    s = tpipe.overlap_schedule([0.3, 0.1, 0.2], [0.6, 0.2, 0.4],
                               num_microbatches=1, hop_fwd_s=[0.05, 0.05],
                               hop_bwd_s=[0.05, 0.05])
    assert s.makespan == s.sequential_s and s.speedup == 1.0


@settings(max_examples=60, deadline=None)
@given(
    segs=st.lists(st.tuples(st.floats(0.01, 2.0), st.floats(0.01, 2.0)),
                  min_size=1, max_size=5),
    k=st.integers(min_value=1, max_value=8),
    hops=st.tuples(st.floats(0.0, 0.5), st.floats(0.0, 0.5),
                   st.floats(0.0, 0.5)),
)
def test_overlap_schedule_matches_jax_exactly(segs, k, hops):
    """Every task's t0/t1, the makespan and the sequential time are the
    reference's, bit for bit, over a sweep of chains, K and hop times
    (the twin of tests/test_pipeline.py's property sweep)."""
    fwd, bwd = [f for f, _ in segs], [b for _, b in segs]
    nb = len(segs) - 1
    kw = dict(num_microbatches=k, hop_fwd_s=[hops[0]] * nb,
              hop_bwd_s=[hops[1]] * nb, hop_fwd_full_s=[hops[2]] * nb)
    got = tpipe.overlap_schedule(fwd, bwd, **kw)
    want = jpipe.overlap_schedule(fwd, bwd, **kw)
    assert _sched_fields(got) == _sched_fields(want)
    if k == 1 and hops[0] == hops[2]:
        assert got.makespan == got.sequential_s


@settings(max_examples=40, deadline=None)
@given(
    costs=st.lists(st.floats(1.0, 2e5), min_size=1, max_size=4),
    tfs=st.lists(st.floats(0.25, 4.0), min_size=4, max_size=4),
    k=st.integers(min_value=1, max_value=8),
    latency=st.floats(0.0, 0.1),
    nbytes=st.one_of(st.none(), st.integers(0, 10**7)),
)
def test_schedule_for_matches_jax_exactly(costs, tfs, k, latency, nbytes):
    devs = [f"d{i % 2}" for i in range(len(costs))]
    tf = {"d0": tfs[0], "d1": tfs[1]}
    hops = None if nbytes is None else \
        [nbytes + i for i in range(2 * (len(costs) - 1))]
    kw = dict(num_microbatches=k, lan_latency_s=latency, hop_bytes=hops,
              lan_bandwidth_bps=1e6 * tfs[2])
    assert _sched_fields(tpipe.schedule_for(costs, devs, tf, **kw)) == \
        _sched_fields(jpipe.schedule_for(costs, devs, tf, **kw))


def test_overlap_schedule_rejects_what_the_reference_rejects():
    for args in (([0.1, 0.2], [0.1]), ([0.1, 0.2], [0.1, 0.2])):
        for mod in (tpipe, jpipe):
            with pytest.raises(ValueError):
                mod.overlap_schedule(*args, num_microbatches=2,
                                     hop_fwd_s=[], hop_bwd_s=[])


# ---------------------------------------------------------------------------
# pricing: plan_epoch_time at K > 1, the epoch report, the Fig. 2 sweep
# ---------------------------------------------------------------------------

def _client_pair(caps=(2, 2), tfs=(1.0, 2.0)):
    return (Client("c0", [Device(f"d{i}", tf, cap)
                          for i, (cap, tf) in enumerate(zip(caps, tfs))]),
            JClient("c0", [JDevice(f"d{i}", tf, cap)
                           for i, (cap, tf) in enumerate(zip(caps, tfs))]))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("hop_bytes", [None, [70_000, 70_001, 9_000, 9_001,
                                              5, 6]])
def test_plan_epoch_time_pipelined_matches_jax(strategy, k, hop_bytes):
    client, jclient = _client_pair((2, 2, 1), (1.0, 2.0, 0.5))
    plan = make_plan(client, LAYERS, strategy, 3)
    jplan = jmake_plan(jclient, LAYERS, strategy, 3)
    hops = None if hop_bytes is None else hop_bytes[:2 * plan.num_boundaries]
    kw = dict(batches_per_epoch=24, lan_latency_s=0.03, boundary_bytes=hops,
              lan_bandwidth_bps=2e6, pipeline_microbatches=k)
    got = tsim.plan_epoch_time(plan, client, **kw)
    assert got == jsim.plan_epoch_time(jplan, jclient, **kw)
    if k == 1:
        assert got == tsim.plan_epoch_time(plan, client, 24, 0.03,
                                           boundary_bytes=hops,
                                           lan_bandwidth_bps=2e6)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("preset", ["paper", "uniform"])
def test_epoch_time_report_matches_jax(strategy, preset):
    pool, jpool = make_pool(preset, 5, 3, 1), jmake_pool(preset, 5, 3, 1)
    for seed in (0, 4):
        got = tsim.epoch_time_report(pool, LAYERS, strategy, seed=seed,
                                     batches_per_epoch=12)
        want = jsim.epoch_time_report(jpool, LAYERS, strategy, seed=seed,
                                      batches_per_epoch=12)
        assert vars(got) == vars(want)


def test_epoch_time_report_without_a_feasible_client_raises():
    client, jclient = _client_pair((1,), (1.0,))
    for mod, c in ((tsim, client), (jsim, jclient)):
        with pytest.raises(ValueError, match="no feasible client"):
            mod.epoch_time_report([c], LAYERS, "sorted_multi")


@pytest.mark.parametrize("kw", [{}, {"batches_per_epoch": 3,
                                     "lan_latency_s": 0.01}])
def test_strategy_sweep_matches_jax(kw):
    pool, jpool = make_pool("paper", 4, 3, 2), jmake_pool("paper", 4, 3, 2)
    got = tsim.strategy_sweep(pool, LAYERS, seeds=range(4), **kw)
    assert got == jsim.strategy_sweep(jpool, LAYERS, seeds=range(4), **kw)
    assert set(got) == set(STRATEGIES)


# ---------------------------------------------------------------------------
# SplitExecution: the pipelined step
# ---------------------------------------------------------------------------

def _plan(strategy="sorted_multi", seed=3):
    client, jclient = _client_pair()
    return (make_plan(client, LAYERS, strategy, seed), client,
            jmake_plan(jclient, LAYERS, strategy, seed), jclient)


def _exec(stage=None, k=1, strategy="sorted_multi"):
    plan = _plan(strategy)[0]
    return ts.SplitExecution(
        plan, functools.partial(disc_apply_layer, c=C),
        (functools.partial(bce_logits, target=1.0),
         functools.partial(bce_logits, target=0.0)), stage=stage,
        pipeline_microbatches=k)


def _jexec(stage=None, k=1, strategy="sorted_multi"):
    jplan = _plan(strategy)[2]
    return js.SplitExecution(
        jplan, functools.partial(jdisc_apply_layer, c=JC),
        (functools.partial(jbce_logits, target=1.0),
         functools.partial(jbce_logits, target=0.0)), stage=stage,
        pipeline_microbatches=k)


def _stage(name, sigma=0.0):
    base = dict(enabled=True, stage_clip=1.0, stage_sigma=sigma)
    return (ts.make_boundary_stage(SplitConfig(**base), name),
            js.make_boundary_stage(JSplitConfig(**base), name))


def _inputs(n=8, seed=0):
    jparams = jax.tree.map(np.asarray, jdisc_init(jax.random.PRNGKey(seed),
                                                  JC))
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (n, 28, 28, 1)).astype(np.float32)
    fake = np.tanh(rng.standard_normal((n, 28, 28, 1))).astype(np.float32)
    return (jparams, params_from_numpy(jparams, "cpu"), real, fake,
            torch.tensor(real), torch.tensor(fake))


def _assert_grads_close(got, want, tol):
    """Each leaf within ``tol`` of its largest magnitude; the BN-fed
    biases (zero analytic gradient, rounding noise) of the whole
    gradient's largest."""
    want = [np.asarray(w) for w in want]
    top = max(float(np.abs(w).max()) for w in want)
    for path, a, w in zip(_paths(got), leaves(got), want):
        scale = top if path in BN_FED_BIASES else np.abs(w).max()
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=tol * scale,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", ["identity", "int8+dp"])
@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_run_pipelined_k1_is_run_bit_for_bit(name, sigma):
    _, params, _, _, r, f = _inputs()
    ex = _exec(_stage(name, sigma)[0], k=4)
    key = keys.root(keys.STAGE, 3)
    sl, sg, _ = ex.run(params, (r, f), key)
    pl, pg, _ = ex.run_pipelined(params, (r, f), key, num_microbatches=1)
    assert torch.equal(pl, sl)
    for a, b in zip(leaves(pg), leaves(sg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["identity", "int8+dp"])
@pytest.mark.parametrize("k", [2, 4])
def test_run_pipelined_matches_jax(name, k):
    """Loss at 1e-5 relative, gradients at 1e-5 (identity) or 1e-4
    (int8) of each leaf's largest magnitude, stage noise off; the
    collected crossings at 1e-5 (identity) or one int8 quantum (1/127 of
    the largest element) of the reference's."""
    jparams, params, real, fake, r, f = _inputs(seed=2)
    st_, jst = _stage(name)
    ex, jex = _exec(st_, k), _jexec(jst, k)
    l, g, rec = ex.run_pipelined(params, (r, f), keys.root(keys.STAGE, 0),
                                 collect=True)
    jl, jg, jrec = jex.run_pipelined(
        jax.tree.map(jnp.asarray, jparams),
        (jnp.asarray(real), jnp.asarray(fake)), jax.random.PRNGKey(0),
        collect=True)
    lossy = name != "identity"
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    _assert_grads_close(g, jax.tree.leaves(jg), 1e-4 if lossy else 1e-5)
    cross_tol = 1 / 127 if lossy else 1e-5
    for d in ("fwd", "bwd"):
        for got, want in zip(rec[d], jrec[d]):
            for a, w in zip(got, want):
                w = np.asarray(w)
                assert a.shape == w.shape and a.shape[0] == 8
                np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                           atol=cross_tol * np.abs(w).max())


@pytest.mark.parametrize("k", [2, 4])
def test_run_pipelined_is_the_mean_of_chunk_monolithic_grads(k):
    """The identity-stage pipelined step equals the mean over micro-batches
    of the monolithic chunk gradient, summed in chunk order and scaled by
    1/K as the step does: bit for bit (the identity split IS the
    monolithic gradient)."""
    _, params, _, _, r, f = _inputs(seed=1)
    pl, pg = _exec(k=k).value_and_grad(params, r, f)
    vg = value_and_grad(functools.partial(d_loss_fn, c=C))
    mb = 8 // k
    cl = [vg(params, r[m * mb:(m + 1) * mb], f[m * mb:(m + 1) * mb])
          for m in range(k)]
    loss, grads = cl[0]
    for l, g in cl[1:]:
        loss, grads = loss + l, tree_map(torch.add, grads, g)
    assert torch.equal(pl, loss * (1.0 / k))
    for a, b in zip(leaves(pg), leaves(tree_map(lambda g: g * (1.0 / k),
                                                grads))):
        assert torch.equal(a, b)


def test_pipelined_step_draws_other_noise_per_microbatch():
    """Micro-batch m's stage key is fold_in(key, m): with noise on, K = 2
    differs from running both halves on the unfolded key."""
    _, params, _, _, r, f = _inputs()
    st_ = _stage("int8+dp", 0.5)[0]
    key = keys.root(keys.STAGE, 9)
    pl, _, _ = _exec(st_, k=2).run_pipelined(params, (r, f), key)
    l0, _, _ = _exec(st_).run(params, (r[:4], f[:4]), keys.fold_in(key, 0))
    l1, _, _ = _exec(st_).run(params, (r[4:], f[4:]), keys.fold_in(key, 1))
    assert torch.equal(pl, (l0 + l1) * 0.5)
    same, _, _ = _exec(st_).run(params, (r[:4], f[:4]), key)
    assert not torch.equal(same, l0)


def test_pipeline_k_in_signature():
    a, b, c = _exec(), _exec(k=4), _exec(k=4)
    assert a.signature != b.signature and b.signature == c.signature
    assert ("pipeline", 4) in b.signature
    jb = _jexec(k=4).signature
    assert (b.signature[0], b.signature[2]) == (jb[0], jb[2])


def test_shipped_boundaries_give_the_full_batch_view():
    _, params, _, _, r, f = _inputs()
    ex = _exec(_stage("int8+dp", 0.5)[0], k=4)
    recs = ex.shipped_boundaries(params, r, f, keys.root(keys.STAGE, 1))
    assert ex.num_boundaries >= 1
    for d in ("fwd", "bwd"):
        for b in range(ex.num_boundaries):
            for p in range(ex.num_passes):
                assert recs[d][b][p].shape[0] == 8
    # unpipelined: the same shapes from one message a crossing
    one = _exec(_stage("int8+dp", 0.5)[0]).shipped_boundaries(
        params, r, f, keys.root(keys.STAGE, 1))
    assert [t.shape for t in one["fwd"][0]] == \
        [t.shape for t in recs["fwd"][0]]


# ---------------------------------------------------------------------------
# the pipelined timeline and schedule of an execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("hop_bytes", [None, "measured"])
def test_round_timeline_pipelined_matches_jax(k, hop_bytes):
    """Phases and makespan equal to the reference's; the batch time is
    plan_epoch_time's at the same K; segment spans overlap across
    devices."""
    st_, jst = _stage("int8+dp", 0.5)
    ex, jex = _exec(st_, k), _jexec(jst, k)
    plan, client, jplan, jclient = _plan()
    tf = {d.device_id: d.time_factor for d in client.devices}
    hops = None
    if hop_bytes:
        _, params, _, _, _, _ = _inputs()
        _, per = ex.step_wire_bytes(params, (8, 28, 28, 1))
        hops = [2 * b[d] for b in per for d in ("fwd", "bwd")]
    kw = dict(lan_latency_s=0.01, hop_bytes=hops, lan_bandwidth_bps=1e6)
    phases, t = ex.round_timeline(tf, **kw)
    jphases, jt = jex.round_timeline(tf, **kw)
    assert phases == jphases and t == jt
    assert t == tsim.plan_epoch_time(
        plan, client, 1, 0.01, boundary_bytes=hops, lan_bandwidth_bps=1e6,
        pipeline_microbatches=k)
    comp = [p for p in phases if p["cat"] == "segment"]
    assert any(a["track"] != b["track"] and a["t0"] < b["t1"]
               and b["t0"] < a["t1"] for a in comp for b in comp)
    seq, seq_t = ex.round_timeline(tf, pipeline_microbatches=1, **kw)
    assert (seq, seq_t) == jex.round_timeline(tf, pipeline_microbatches=1,
                                              **kw)
    assert seq_t >= t
    assert _sched_fields(ex.overlap_schedule(tf, **kw)) == \
        _sched_fields(jex.overlap_schedule(tf, **kw))


# ---------------------------------------------------------------------------
# the pipelined step through the boundary_fuse kernel (GPU only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4])
def test_pipelined_step_launches_the_kernel_per_microbatch_on_gpu(
        cuda_fp32, k):
    """K micro-batches: one boundary_fuse launch a crossing a micro-batch
    (2 passes x 2 directions x boundaries x K), never the plain version.
    Against the same step on the plain version with the same keys: the
    kernel's clip norms sum in another order, so the next crossing's
    input can round to the other int8 quantum, in a micro-batch of as few
    as 2 examples; the loss at 1e-4, the gradients at one quantum (1/127)
    of each leaf's largest (the classifier's weight gradient is its input
    times one number a row)."""
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    jparams, _, real, fake, _, _ = _inputs()
    params = params_from_numpy(jparams, cuda_fp32)
    r = torch.tensor(real, device=cuda_fp32)
    f = torch.tensor(fake, device=cuda_fp32)
    base = dict(enabled=True, stage_clip=1.0, stage_sigma=0.5)
    kern = _exec(ts.make_boundary_stage(SplitConfig(**base, use_kernel=True),
                                        "int8+dp"), k)
    plain = _exec(ts.make_boundary_stage(SplitConfig(**base), "int8+dp"), k)
    key = keys.root(keys.STAGE, 2)
    before = boundary_fuse_kernel.launches
    kl, kg = kern.value_and_grad(params, r, f, key)
    assert boundary_fuse_kernel.launches - before == \
        4 * kern.num_boundaries * k
    pl, pg = plain.value_and_grad(params, r, f, key)
    assert boundary_fuse_kernel.launches - before == \
        4 * kern.num_boundaries * k
    np.testing.assert_allclose(float(kl), float(pl), rtol=1e-4)
    _assert_grads_close(tree_map(torch.Tensor.cpu, kg),
                        [g.cpu() for g in leaves(pg)], 1 / 127)
