"""The port's executed split held against the JAX package on the CPU: the
fused boundary op, the boundary stages, ``SplitExecution`` and the
measured-bytes pricing; plus the in-port pins (identity stage ==
monolithic gradient bit for bit, fused == composed).

On the CPU the port's ``fused_boundary_flat`` takes its plain version; it
must match the JAX Pallas kernel in interpret mode, fed the same noise, to
rtol 1e-5 / atol 1e-6 (the per-row norm sums in another order), and the
codec's quantize-dequantize must be equal bit for bit.  The CUDA kernel
runs only on a GPU: its tests carry the ``gpu`` marker and skip here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import DCGANConfig as JDCGANConfig
from repro.config import SplitConfig as JSplitConfig
from repro.core import split as js
from repro.core.devices import Client as JClient
from repro.core.devices import Device as JDevice
from repro.core.gan import bce_logits as jbce_logits
from repro.core.selection import make_plan as jmake_plan
from repro.core.simulate import plan_epoch_time as jplan_epoch_time
from repro.kernels.boundary_fuse.kernel import \
    boundary_fuse_kernel as jboundary_fuse_kernel
from repro.kernels.boundary_fuse.ref import codec_qdq as jcodec_qdq
from repro.models.dcgan import disc_apply_layer as jdisc_apply_layer
from repro.models.dcgan import disc_init as jdisc_init
from repro.models.dcgan import disc_layer_costs, disc_layer_names
from repro_torch import keys
from repro_torch.bridge import params_from_numpy
from repro_torch.config import DCGANConfig, SplitConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import split as ts
from repro_torch.core.devices import Client, Device
from repro_torch.core.gan import FSLGANTrainer, bce_logits, d_loss_fn
from repro_torch.core.selection import STRATEGIES, make_plan
from repro_torch.core.simulate import plan_epoch_time
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
from repro_torch.kernels.boundary_fuse.ops import fused_boundary_flat
from repro_torch.kernels.boundary_fuse.ref import (codec_qdq,
                                                   fused_boundary_ref)
from repro_torch.models.dcgan import disc_apply_layer
from repro_torch.tree import leaves, value_and_grad

TOL = dict(rtol=1e-5, atol=1e-6)
FUSABLE = ("none", "fp16", "int8")
JC, C = JDCGANConfig(base_filters=8), DCGANConfig(base_filters=8)
STAGES = ("identity", "fp16", "int8", "topk", "dp", "fp16+dp", "int8+dp",
          "topk+dp")


def _x(b, n, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, n)) * scale).astype(np.float32),
            rng.standard_normal((b, n)).astype(np.float32))


# ---------------------------------------------------------------------------
# the fused boundary op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", FUSABLE)
@pytest.mark.parametrize("b,n", [(8, 392), (3, 4097), (2, 1), (4, 2048)])
def test_codec_qdq_matches_jax_bit_for_bit(codec, b, n):
    x, _ = _x(b, n, seed=b * 101 + n)
    np.testing.assert_array_equal(
        codec_qdq(torch.tensor(x), codec).numpy(),
        np.asarray(jcodec_qdq(jnp.asarray(x), codec)))


@pytest.mark.parametrize("codec", FUSABLE)
@pytest.mark.parametrize("b,n", [(8, 392), (3, 4097), (2, 1), (5, 7)])
@pytest.mark.parametrize("clip,noise_scale", [(1.0, 0.0), (1.0, 0.5),
                                              (1e6, 0.0)])
def test_fused_boundary_flat_matches_jax_kernel(codec, b, n, clip,
                                                noise_scale):
    x, z = _x(b, n, seed=b * 31 + n)
    want = jboundary_fuse_kernel(jnp.asarray(x), clip, noise_scale,
                                 jnp.asarray(z), codec=codec, interpret=True)
    got = fused_boundary_flat(torch.tensor(x), clip, noise_scale,
                              torch.tensor(z), codec=codec, use_kernel=True)
    assert got.shape == (b, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("codec", FUSABLE)
def test_all_zero_tensor_stays_zero(codec):
    """int8 takes the scale 1.0 branch; the zero rows skip the clip."""
    x = torch.zeros((3, 50))
    got = fused_boundary_flat(x, 1.0, 0.0, torch.zeros_like(x), codec=codec)
    assert torch.equal(got, x)
    want = jboundary_fuse_kernel(jnp.zeros((3, 50)), 1.0, 0.0,
                                 jnp.zeros((3, 50)), codec=codec,
                                 interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_plain_version_not_the_kernel():
    x, z = _x(3, 100, seed=1)
    before = boundary_fuse_kernel.launches
    fused_boundary_flat(torch.tensor(x), 1.0, 0.5, torch.tensor(z),
                        codec="int8", use_kernel=True)
    assert boundary_fuse_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        boundary_fuse_kernel(torch.tensor(x), 1.0, 0.5, torch.tensor(z),
                             codec="int8")
    with pytest.raises(ValueError, match="fusable"):
        boundary_fuse_kernel(torch.tensor(x), 1.0, 0.5, torch.tensor(z),
                             codec="topk")


def _x_rows(b, n, seed):
    """``_x`` with rows of magnitudes spread over three decades, so that a
    per-row amax differs from the tensor's."""
    x, z = _x(b, n, seed)
    return x * np.logspace(-2, 1, b, dtype=np.float32)[:, None], z


def _jax_per_example(x, z, clip, noise_scale, codec):
    """The reference's per-example call: ``jax.vmap`` of the Pallas kernel
    (interpret mode) over (1, N) rows."""
    return np.asarray(jax.vmap(lambda a, b: jboundary_fuse_kernel(
        a[None], clip, noise_scale, b[None], codec=codec,
        interpret=True)[0])(jnp.asarray(x), jnp.asarray(z)))


@pytest.mark.parametrize("codec", FUSABLE)
@pytest.mark.parametrize("b,n", [(8, 392), (3, 4097), (2, 1)])
@pytest.mark.parametrize("clip,noise_scale", [(1.0, 0.0), (1.0, 0.5),
                                              (1e6, 0.0)])
def test_row_amax_matches_jax_vmap_of_the_kernel(codec, b, n, clip,
                                                 noise_scale):
    x, z = _x_rows(b, n, seed=b * 17 + n)
    want = _jax_per_example(x, z, clip, noise_scale, codec)
    got = fused_boundary_flat(torch.tensor(x), clip, noise_scale,
                              torch.tensor(z), codec=codec, amax="row",
                              use_kernel=True)
    assert got.shape == (b, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if codec == "int8" and n > 1:
        # the rows' own scales, not the tensor's
        tensor = fused_boundary_flat(torch.tensor(x), clip, noise_scale,
                                     torch.tensor(z), codec=codec)
        assert not np.allclose(tensor.numpy(), want, **TOL)


@pytest.mark.parametrize("codec", FUSABLE)
@pytest.mark.parametrize("n", [1, 392, 4097])
def test_row_amax_of_one_example_is_the_tensor_amax_bit_for_bit(codec, n):
    x, z = _x(1, n, seed=n + 5)
    xs, zs = torch.tensor(x), torch.tensor(z)
    assert torch.equal(
        fused_boundary_flat(xs, 1.0, 0.5, zs, codec=codec, amax="row"),
        fused_boundary_flat(xs, 1.0, 0.5, zs, codec=codec))


def _nan_case(b=6, n=300, row=2):
    x, z = _x_rows(b, n, seed=77)
    x[row, 123] = np.nan
    return torch.tensor(x), torch.tensor(z), row


def test_row_amax_nan_changes_only_its_own_rows_scale():
    """A NaN makes its row's amax NaN, so that row alone takes the int8
    scale 1.0 (and its norm, so the whole row, is NaN after the clip);
    every other row is what it is without the NaN."""
    x, z, row = _nan_case()
    clean = x.clone()
    clean[row, 123] = 0.0
    q = codec_qdq(x, "int8", amax="row")
    q_clean = codec_qdq(clean, "int8", amax="row")
    others = torch.arange(x.shape[0]) != row
    assert torch.equal(q[others], q_clean[others])
    keep = ~torch.isnan(x[row])
    assert int(torch.isnan(q[row]).sum()) == 1
    assert torch.equal(q[row][keep],
                       torch.clamp(torch.round(x[row][keep]), -127, 127))
    out = fused_boundary_flat(x, 1.0, 0.5, z, codec="int8", amax="row")
    want = fused_boundary_flat(clean, 1.0, 0.5, z, codec="int8", amax="row")
    assert bool(torch.isnan(out[row]).all())
    assert torch.equal(out[others], want[others])
    # the tensor-wide amax is NaN: every row takes the scale 1.0
    qt = codec_qdq(x, "int8")
    assert torch.equal(qt[others],
                       torch.clamp(torch.round(x[others]), -127, 127))


def test_unknown_amax_mode_raises():
    x, z = _x(2, 8, seed=0)
    with pytest.raises(ValueError, match="amax"):
        fused_boundary_flat(torch.tensor(x), 1.0, 0.0, torch.tensor(z),
                            codec="int8", amax="column")
    with pytest.raises(ValueError, match="amax"):
        boundary_fuse_kernel(torch.tensor(x), 1.0, 0.0, torch.tensor(z),
                             codec="int8", amax="column")


# ---------------------------------------------------------------------------
# boundary stages
# ---------------------------------------------------------------------------

def _scfg(**over):
    base = dict(enabled=True, stage_clip=1.0, stage_sigma=0.5, topk_frac=0.1)
    base.update(over)
    return SplitConfig(**base), JSplitConfig(**base)


@pytest.mark.parametrize("name", ["int8+dp", "fp16+dp"])
def test_make_boundary_stage_selects_fused(name):
    cfg, _ = _scfg()
    assert isinstance(ts.make_boundary_stage(cfg, name),
                      ts.FusedBoundaryStage)
    cfg_off, _ = _scfg(fuse_boundary=False)
    assert isinstance(ts.make_boundary_stage(cfg_off, name),
                      ts.ComposedBoundaryStage)
    assert isinstance(ts.make_boundary_stage(cfg, "topk+dp"),
                      ts.ComposedBoundaryStage)


@pytest.mark.parametrize("name", ["int8+dp", "fp16+dp"])
def test_fused_stage_matches_composed(name):
    """The port's twin of tests/test_pipeline.py's pin: the fused stage
    computes what the two-stage composition computes, with the same noise
    for the same key, to 3e-6 (the clip's norm sums in another order)."""
    cfg, _ = _scfg()
    cfg_off, _ = _scfg(fuse_boundary=False)
    fused = ts.make_boundary_stage(cfg, name)
    composed = ts.make_boundary_stage(cfg_off, name)
    for p in range(2):
        x = torch.tensor(_x(8, 196, seed=10 + p)[0]).reshape(8, 7, 7, 4)
        kp = keys.fold_in(keys.root(keys.STAGE, 7), p)
        np.testing.assert_allclose(fused.apply(x, kp).numpy(),
                                   composed.apply(x, kp).numpy(),
                                   atol=3e-6, rtol=3e-6)


@pytest.mark.parametrize("name", STAGES)
def test_stage_wire_bytes_and_noiseless_output_match_jax(name):
    cfg, jcfg = _scfg(stage_sigma=0.0)
    st, jst = ts.make_boundary_stage(cfg, name), js.make_boundary_stage(
        jcfg, name)
    assert st.name == jst.name and st.stochastic == jst.stochastic
    for shape in ((8, 7, 7, 16), (3, 4, 4, 32)):
        assert st.wire_bytes(shape) == jst.wire_bytes(shape)
    x = _x(8, 784, seed=3)[0].reshape(8, 7, 7, 16)
    got = st.apply(torch.tensor(x), keys.root(keys.STAGE, 0))
    want = jst.apply(jnp.asarray(x), jax.random.PRNGKey(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# SplitExecution
# ---------------------------------------------------------------------------

def _plan(strategy, seed=3, torch_side=True):
    costs = disc_layer_costs(JC)
    layers = [(n, costs[n]) for n in disc_layer_names(JC)]
    if torch_side:
        client = Client("c0", [Device(f"d{i}", tf, cap) for i, (cap, tf)
                               in enumerate(zip([2, 2], [1.0, 2.0]))])
        return make_plan(client, layers, strategy, seed), client
    client = JClient("c0", [JDevice(f"d{i}", tf, cap) for i, (cap, tf)
                            in enumerate(zip([2, 2], [1.0, 2.0]))])
    return jmake_plan(client, layers, strategy, seed), client


def _exec(strategy="sorted_single", stage=None):
    plan, _ = _plan(strategy)
    return ts.SplitExecution(
        plan, functools.partial(disc_apply_layer, c=C),
        (functools.partial(bce_logits, target=1.0),
         functools.partial(bce_logits, target=0.0)), stage=stage)


def _jexec(strategy="sorted_single", stage=None):
    plan, _ = _plan(strategy, torch_side=False)
    return js.SplitExecution(
        plan, functools.partial(jdisc_apply_layer, c=JC),
        (functools.partial(jbce_logits, target=1.0),
         functools.partial(jbce_logits, target=0.0)), stage=stage)


def _inputs(n=4, seed=0):
    jparams = jax.tree.map(np.asarray, jdisc_init(jax.random.PRNGKey(seed),
                                                  JC))
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (n, 28, 28, 1)).astype(np.float32)
    fake = np.tanh(rng.standard_normal((n, 28, 28, 1))).astype(np.float32)
    return jparams, real, fake


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_identity_split_is_the_monolithic_gradient_bit_for_bit(strategy):
    """The port's twin of tests/test_split_selection.py's pin."""
    jparams, real, fake = _inputs()
    params = params_from_numpy(jparams, "cpu")
    r, f = torch.tensor(real), torch.tensor(fake)
    ml, mg = value_and_grad(functools.partial(d_loss_fn, c=C))(params, r, f)
    ex = _exec(strategy)
    assert ex.num_boundaries >= 1
    sl, sg = ex.value_and_grad(params, r, f)
    assert torch.equal(sl, ml)
    for a, b in zip(leaves(sg), leaves(mg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["identity", "int8", "fp16", "int8+dp",
                                  "dp"])
def test_split_run_matches_jax(name):
    """Loss, every gradient leaf and the crossing tensors of one staged
    step against the JAX executor (stage noise off): gradients at 1e-5 of
    each leaf's largest magnitude (BN-fed biases: of the whole gradient's;
    their analytic gradient is zero), crossings at 1e-5 of their largest.

    Through a codec, an input that differs between frameworks in the 7th
    digit can round the other way: that crossing element moves by one
    quantum (at most 1/127 of the tensor's amax for int8, 2^-11 relative
    for fp16) and the gradients upstream of it by about 1e-5.  So codec
    stages hold crossings to one int8 quantum and gradients to 1e-4."""
    cfg, jcfg = _scfg(stage_sigma=0.0)
    jparams, real, fake = _inputs(seed=2)
    ex = _exec("sorted_multi", ts.make_boundary_stage(cfg, name))
    jex = _jexec("sorted_multi", js.make_boundary_stage(jcfg, name))
    assert ex.signature[0] == jex.signature[0]
    l, g, rec = ex.run(params_from_numpy(jparams, "cpu"),
                       (torch.tensor(real), torch.tensor(fake)),
                       keys.root(keys.STAGE, 0), collect=True)
    jl, jg, jrec = jex.run(jax.tree.map(jnp.asarray, jparams),
                           (jnp.asarray(real), jnp.asarray(fake)),
                           jax.random.PRNGKey(0), collect=True)
    lossy = name.split("+")[0] in ("fp16", "int8")
    grad_tol, cross_tol = (1e-4, 1 / 127) if lossy else (1e-5, 1e-5)
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    top = max(float(np.abs(np.asarray(w)).max()) for w in
              jax.tree.leaves(jg))
    paths = [("classifier", "b"), ("classifier", "w"), ("conv0", "b"),
             ("conv0", "w"), ("conv1", "b"), ("conv1", "bn", "bias"),
             ("conv1", "bn", "scale"), ("conv1", "w"), ("conv2", "b"),
             ("conv2", "bn", "bias"), ("conv2", "bn", "scale"),
             ("conv2", "w")]
    for path, a, w in zip(paths, leaves(g), jax.tree.leaves(jg)):
        w = np.asarray(w)
        scale = top if path in (("conv1", "b"), ("conv2", "b")) \
            else np.abs(w).max()
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=grad_tol * scale, err_msg=str(path))
    for d in ("fwd", "bwd"):
        for got, want in zip(rec[d], jrec[d]):
            for a, w in zip(got, want):
                w = np.asarray(w)
                np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                           atol=cross_tol * np.abs(w).max())


def test_fused_execution_matches_composed_execution():
    """Full staged run (fwd + bwd crossings, noise on) under the fused
    stage equals the unfused composition — loss and every gradient leaf."""
    jparams, real, fake = _inputs()
    params = params_from_numpy(jparams, "cpu")
    batches = (torch.tensor(real), torch.tensor(fake))
    key = keys.root(keys.STAGE, 11)
    cfg, _ = _scfg()
    cfg_off, _ = _scfg(fuse_boundary=False)
    fl, fg, _ = _exec(stage=ts.make_boundary_stage(cfg, "int8+dp")).run(
        params, batches, key)
    cl, cg, _ = _exec(stage=ts.make_boundary_stage(cfg_off, "int8+dp")).run(
        params, batches, key)
    np.testing.assert_allclose(float(fl), float(cl), atol=3e-6, rtol=3e-6)
    for a, b in zip(leaves(fg), leaves(cg)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-6,
                                   rtol=3e-6)


@pytest.mark.parametrize("name", STAGES)
def test_step_wire_bytes_and_shapes_match_jax(name):
    cfg, jcfg = _scfg()
    jparams, _, _ = _inputs()
    for strategy in STRATEGIES:
        ex = _exec(strategy, ts.make_boundary_stage(cfg, name))
        jex = _jexec(strategy, js.make_boundary_stage(jcfg, name))
        params = params_from_numpy(jparams, "cpu")
        shape = (8, 28, 28, 1)
        assert ex.boundary_shapes(params, shape) == jex.boundary_shapes(
            jparams, shape)
        assert ex.step_wire_bytes(params, shape) == jex.step_wire_bytes(
            jparams, shape)
        assert ex.segment_costs() == jex.segment_costs()
        assert [tuple(vars(b).values()) for b in ex.boundaries] == \
            [tuple(vars(b).values()) for b in jex.boundaries]


@pytest.mark.parametrize("hop_bytes", [None, "measured"])
def test_round_timeline_and_measured_pricing_match_jax(hop_bytes):
    cfg, jcfg = _scfg()
    ex = _exec("sorted_multi", ts.make_boundary_stage(cfg, "int8+dp"))
    jex = _jexec("sorted_multi", js.make_boundary_stage(jcfg, "int8+dp"))
    plan, client = _plan("sorted_multi")
    jplan, jclient = _plan("sorted_multi", torch_side=False)
    tf = {d.device_id: d.time_factor for d in client.devices}
    hops = None
    if hop_bytes:
        jparams, _, _ = _inputs()
        _, per = ex.step_wire_bytes(params_from_numpy(jparams, "cpu"),
                                    (8, 28, 28, 1))
        hops = [2 * b[d] for b in per for d in ("fwd", "bwd")]
    phases, t = ex.round_timeline(tf, lan_latency_s=0.02, hop_bytes=hops,
                                  lan_bandwidth_bps=1e6)
    jphases, jt = jex.round_timeline(tf, lan_latency_s=0.02, hop_bytes=hops,
                                     lan_bandwidth_bps=1e6)
    assert phases == jphases and t == jt
    price = plan_epoch_time(plan, client, 3, 0.02, boundary_bytes=hops,
                            lan_bandwidth_bps=1e6)
    assert price == jplan_epoch_time(jplan, jclient, 3, 0.02,
                                     boundary_bytes=hops,
                                     lan_bandwidth_bps=1e6)
    np.testing.assert_allclose(price, 3 * t, rtol=1e-12)


def test_forward_boundaries_and_partition():
    jparams, real, _ = _inputs()
    params = params_from_numpy(jparams, "cpu")
    ex = _exec("sorted_multi")
    acts = ex.forward_boundaries(params, torch.tensor(real))
    assert [tuple(a.shape) for a in acts] == ex.boundary_shapes(
        params, real.shape)
    parts = ts.partition_params(ex.plan, params)
    assert [n for p in parts for n in p] == ex.plan.layers_in_order()
    assert ts.tensor_wire_bytes((2, 3)) == js.tensor_wire_bytes((2, 3))


def test_pipelined_split_is_not_ported():
    plan, _ = _plan("sorted_single")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.SplitExecution(plan, None, (), pipeline_microbatches=2)


# ---------------------------------------------------------------------------
# the trainer, in the port
# ---------------------------------------------------------------------------

SMALL = {"shape.global_batch": 8, "fsl.num_clients": 2,
         "model.dcgan.base_filters": 8}


@pytest.fixture(scope="module")
def parts():
    imgs, labels = synthetic_mnist(120, seed=0)
    return partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)


def _trainer(parts, over):
    return FSLGANTrainer(get_config("dcgan-mnist").override(
        {**SMALL, **over}), parts, seed=0, device="cpu")


def test_identity_split_round_equals_unsplit_round_bit_for_bit(parts):
    ta = _trainer(parts, {"split.enabled": True})
    tb = _trainer(parts, {})
    assert any(ex.num_boundaries for ex in ta.split_execs.values())
    for _ in range(2):
        ma, mb = ta.train_epoch(batches_per_client=2), tb.train_epoch(
            batches_per_client=2)
        for k in ("d_loss", "g_loss"):
            assert ma[k] == mb[k]
        assert ma["lan_mbytes"] > 0 and "lan_mbytes" not in mb
    for a, b in zip(leaves(ta.state.d_params["c0"]),
                    leaves(tb.state.d_params["c0"])):
        assert torch.equal(a, b)


def test_noisy_stage_runs_repeat_and_lan_bytes_are_measured(parts):
    over = {"split.enabled": True, "split.boundary_stage": "int8+dp",
            "split.stage_sigma": 0.5}
    ta, tb = _trainer(parts, over), _trainer(parts, over)
    for _ in range(2):
        ma = ta.train_epoch(batches_per_client=1)
        assert ma == tb.train_epoch(batches_per_client=1)
    for a, b in zip(leaves(ta.state.g_params), leaves(tb.state.g_params)):
        assert torch.equal(a, b)
    x_shape = (8, 28, 28, 1)
    want = sum(ex.step_wire_bytes(ta.state.d_params[cid], x_shape)[0]
               for cid, ex in ta.split_execs.items())
    assert ma["lan_mbytes"] == want / 1e6
    with pytest.raises(ValueError, match="identity"):
        ta.train_epoch_sequential(batches_per_client=1)


# ---------------------------------------------------------------------------
# the CUDA kernel (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the boundary_fuse kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("codec", FUSABLE)
@pytest.mark.parametrize("b,n", [(256, 6272), (256, 4096), (2, 1),
                                 (3, 4097)])
@pytest.mark.parametrize("noise_scale", [0.0, 0.5])
def test_kernel_matches_plain_version_on_gpu(cuda, codec, b, n,
                                             noise_scale):
    x, z = _x(b, n, seed=n + b)
    xs, zs = torch.tensor(x, device=cuda), torch.tensor(z, device=cuda)
    before = boundary_fuse_kernel.launches
    got = boundary_fuse_kernel(xs, 1.0, noise_scale, zs, codec=codec)
    torch.cuda.synchronize()
    assert boundary_fuse_kernel.launches == before + 1
    torch.testing.assert_close(
        got, fused_boundary_ref(xs, 1.0, noise_scale, zs, codec=codec),
        rtol=1e-5, atol=1e-6)
    # before the clip the qdq is the codec's, bit for bit
    q = boundary_fuse_kernel(xs, 1e30, 0.0, zs, codec=codec)
    assert torch.equal(q, codec_qdq(xs, codec))


def _gpu_case(cuda, b, n, seed, offset=0):
    """(B, N) x and z on the card, x with rows over three decades;
    ``offset`` floats into a larger buffer, so that x sits that many
    4-byte steps off a 16-byte boundary."""
    x, z = _x_rows(b, n, seed)
    buf = torch.empty(b * n + offset, device=cuda)
    xs = buf[offset:].view(b, n)
    xs.copy_(torch.tensor(x))
    return xs, torch.tensor(z, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("codec", FUSABLE)
@pytest.mark.parametrize("amax", ["tensor", "row"])
@pytest.mark.parametrize("b,n,offset", [
    (256, 6272, 0), (256, 4096, 0), (256, 12544, 0), (3, 4097, 0),
    (4096, 64, 0),           # more rows than the card holds CTAs at once
    (4, 300000, 0),          # rows too long to hold on chip
    (5, 999, 1), (256, 6272, 1)])    # x 4 bytes off a 16-byte boundary
def test_kernel_amax_modes_match_plain_version_on_gpu(cuda, codec, amax, b,
                                                      n, offset):
    xs, zs = _gpu_case(cuda, b, n, seed=b + n, offset=offset)
    before = boundary_fuse_kernel.launches
    got = boundary_fuse_kernel(xs, 1.0, 0.5, zs, codec=codec, amax=amax)
    torch.cuda.synchronize()
    assert boundary_fuse_kernel.launches == before + 1
    torch.testing.assert_close(
        got, fused_boundary_ref(xs, 1.0, 0.5, zs, codec=codec, amax=amax),
        rtol=1e-5, atol=1e-6)
    q = boundary_fuse_kernel(xs, 1e30, 0.0, zs, codec=codec, amax=amax)
    assert torch.equal(q, codec_qdq(xs, codec, amax))
    # the same bits from a second launch
    assert torch.equal(q, boundary_fuse_kernel(xs, 1e30, 0.0, zs,
                                               codec=codec, amax=amax))


@pytest.mark.gpu
@pytest.mark.parametrize("amax", ["tensor", "row"])
def test_kernel_nan_placement_matches_plain_version_on_gpu(cuda, amax):
    x, z, row = _nan_case(b=256, n=6272, row=100)
    xs, zs = x.to(cuda), z.to(cuda)
    for clip, ns in ((1e30, 0.0), (1.0, 0.5)):
        got = boundary_fuse_kernel(xs, clip, ns, zs, codec="int8", amax=amax)
        want = fused_boundary_ref(xs, clip, ns, zs, codec="int8", amax=amax)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        keep = ~torch.isnan(want)
        torch.testing.assert_close(got[keep], want[keep], rtol=1e-5,
                                   atol=1e-6)
        if clip == 1e30:
            assert torch.equal(got[keep], want[keep])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 6272, 300000])
def test_kernel_row_amax_of_one_row_is_the_tensor_amax_on_gpu(cuda, n):
    xs, zs = _gpu_case(cuda, 1, n, seed=n)
    assert torch.equal(
        boundary_fuse_kernel(xs, 1.0, 0.5, zs, codec="int8", amax="row"),
        boundary_fuse_kernel(xs, 1.0, 0.5, zs, codec="int8"))
