"""The port's privacy slice held against the JAX package on the CPU: the
dp_clip op, per-example gradients, the DP-SGD step (monolithic and through
the executed split), the uplink DP stage and the RDP accountant; plus the
in-port pins of DP-SGD and uplink DP.

On the CPU the port's ``dp_clip_noise_flat`` takes its plain version; it
must match the JAX Pallas kernel run in interpret mode, fed the same noise
array, to rtol 1e-5 / atol 1e-6 (a sum over B clipped examples in another
order).  The RDP math is the reference's own Python, so epsilon must be
equal to the last bit.  The CUDA kernel runs only on a GPU: its tests
carry the ``gpu`` marker and skip here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import cuda, cuda_fp32, one_thread  # noqa: F401

from repro.config import DCGANConfig as JDCGANConfig
from repro.config import OptimConfig as JOptimConfig
from repro.config import PrivacyConfig as JPrivacyConfig
from repro.config import SplitConfig as JSplitConfig
from repro.core import split as js
from repro.core.devices import Client as JClient
from repro.core.devices import Device as JDevice
from repro.core.gan import bce_logits as jbce_logits
from repro.core.gan import d_loss_fn as jd_loss_fn
from repro.core.selection import make_plan as jmake_plan
from repro.fed.programs import make_local_step as jmake_local_step
from repro.kernels.dp_clip.ops import dp_clip_noise_flat as jdp_clip_noise_flat
from repro.kernels.dp_clip.ops import flatten_per_example as jflatten
from repro.kernels.dp_clip.ops import unflatten_summed as junflatten
from repro.kernels.dp_clip.ref import dp_clip_noise_ref as jdp_clip_noise_ref
from repro.models.dcgan import disc_apply_layer as jdisc_apply_layer
from repro.models.dcgan import disc_init as jdisc_init
from repro.models.dcgan import disc_layer_costs, disc_layer_names
from repro.optim import make_optimizer as jmake_optimizer
from repro.privacy import defenses as jdef
from repro_torch import keys
from repro_torch.bridge import params_from_numpy
from repro_torch.config import (DCGANConfig, OptimConfig, PrivacyConfig,
                                SplitConfig)
from repro_torch.configs.registry import get_config
from repro_torch.core import split as ts
from repro_torch.core.devices import Client, Device
from repro_torch.core.gan import FSLGANTrainer, bce_logits, d_loss_fn
from repro_torch.core.selection import make_plan
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.fed.programs import make_local_step
from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
from repro_torch.kernels.dp_clip.ops import (dp_clip_noise_flat,
                                             dp_clip_noise_tree,
                                             flatten_per_example,
                                             unflatten_summed)
from repro_torch.kernels.dp_clip.ref import dp_clip_noise_ref
from repro_torch.models.dcgan import disc_apply_layer
from repro_torch.optim import make_optimizer
from repro_torch.privacy import defenses as tdef
from repro_torch.tree import leaves, tree_map

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = {"shape.global_batch": 8, "fsl.num_clients": 2,
         "model.dcgan.base_filters": 8}
DP = {"privacy.enabled": True, "privacy.mode": "dp_sgd",
      "privacy.clip_norm": 0.1}
BATCHES = 2
# D biases that feed straight into a batch norm: their analytic gradient is
# zero and the float one is rounding noise that differs between frameworks
# (ROADMAP Queue C), so they are held to the scale of the whole gradient,
# and after an Adam step to lr of their start.
BN_FED_BIASES = {("conv1", "b"), ("conv2", "b")}


def _paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]


def _stack(b, n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, n)) * scale).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


# ---------------------------------------------------------------------------
# the dp_clip op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n", [(6, 16865), (1, 1), (3, 4097), (5, 7),
                                 (2, 2048)])
@pytest.mark.parametrize("clip,noise_scale", [(0.5, 0.0), (0.5, 0.7),
                                              (1e6, 0.0), (1e6, 1.3)])
def test_dp_clip_flat_matches_jax_kernel(b, n, clip, noise_scale):
    """clip 0.5 binds every row; 1e6 leaves every row under the clip."""
    x, z = _stack(b, n, seed=b * 7919 + n)
    want = jdp_clip_noise_flat(jnp.asarray(x), clip, noise_scale,
                               jnp.asarray(z), use_kernel=True,
                               interpret=True)
    got = dp_clip_noise_flat(torch.tensor(x), clip, noise_scale,
                             torch.tensor(z))
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dp_clip_zero_rows_pass_as_zero():
    x, z = _stack(4, 300, seed=3)
    x[1] = 0.0
    got = dp_clip_noise_flat(torch.tensor(x), 0.5, 0.0, torch.tensor(z))
    want = jdp_clip_noise_flat(jnp.asarray(x), 0.5, 0.0, jnp.asarray(z),
                               use_kernel=True, interpret=True)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _per_example_tree(b, seed):
    rng = np.random.default_rng(seed)
    return {"conv0": {"w": rng.standard_normal((b, 5, 5, 1, 3)),
                      "b": rng.standard_normal((b, 3))},
            "classifier": {"w": rng.standard_normal((b, 12, 1)),
                           "b": rng.standard_normal((b, 1))}}


def test_flat_order_is_the_jax_leaf_order():
    """Noise element n lands on the same parameter as in the JAX package:
    the (B, N) stack and the unflattened sum are laid out alike."""
    tree = jax.tree.map(lambda a: a.astype(np.float32),
                        _per_example_tree(3, seed=1))
    jflat, jspec = jflatten(jax.tree.map(jnp.asarray, tree))
    flat, spec = flatten_per_example(params_from_numpy(tree, "cpu"))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    vec = np.arange(flat.shape[1], dtype=np.float32)
    got = unflatten_summed(torch.tensor(vec), spec)
    want = junflatten(jnp.asarray(vec), jspec)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dp_clip_tree_draws_one_normal_per_parameter_from_its_key():
    tree = params_from_numpy(jax.tree.map(
        lambda a: a.astype(np.float32), _per_example_tree(4, seed=2)), "cpu")
    key = keys.fold_in(keys.root(keys.DP_SGD, 5), 1, 0, 0, 0, 1)
    a = dp_clip_noise_tree(tree, 0.3, 0.8, key)
    flat, spec = flatten_per_example(tree)
    noise = keys.normal(key, (flat.shape[1],), "cpu")
    want = unflatten_summed(dp_clip_noise_ref(flat, 0.3, 0.8, noise), spec)
    for g, w in zip(leaves(a), leaves(want)):
        assert torch.equal(g, w)
    b = dp_clip_noise_tree(tree, 0.3, 0.8, keys.fold_in(key, 0))
    assert not torch.equal(leaves(a)[0], leaves(b)[0])


def test_cpu_tensors_take_the_plain_version_not_the_kernel():
    x, z = _stack(3, 100, seed=1)
    before = dp_clip_noise_kernel.launches
    dp_clip_noise_flat(torch.tensor(x), 1.0, 0.5, torch.tensor(z))
    assert dp_clip_noise_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        dp_clip_noise_kernel(torch.tensor(x), 1.0, 0.5, torch.tensor(z))


DP_SPAN = 6144        # the CUDA kernel's row-pass span (csrc/dp_clip.cu kSpan)


def _butterfly(a):
    """Sum the last axis (32 lanes) as the kernel's xor shuffles do:
    offsets 16, 8, 4, 2, 1, lane 0's result."""
    for off in (16, 8, 4, 2, 1):
        a = a + a[..., torch.arange(32) ^ off]
    return a[..., 0]


def _dp_clip_emulation(x, clip, noise_scale, z):
    """The CUDA kernel's order of sums in PyTorch, for a (B, N) fp32 stack
    at a 16-byte-aligned address: each row's spans of DP_SPAN elements, a
    span read as the float4 words of the 16-byte-aligned range around it
    (element n of row b at word position (b N + n) mod 4), lane l of a warp
    summing words l, l + 32, ... in order into one partial sum a word
    component, the lane's (a0 + a1) + (a2 + a3), a butterfly over lanes;
    each row's span partials summed the same way (lane l: spans l,
    l + 32, ...) into its scale; then out[n] = fma(scale[b], x[b, n], acc)
    over b = 0, 1, ... in order, plus noise_scale * z[n]."""
    b, n = x.shape
    spans = -(-n // DP_SPAN)
    width = DP_SPAN + 8
    words = -(-width // 128) * 128           # whole rounds of 32 lanes x 4
    pad = torch.zeros((b, spans, words))
    for bb in range(b):
        for c in range(spans):
            seg = x[bb, c * DP_SPAN:(c + 1) * DP_SPAN]
            off = (bb * n + c * DP_SPAN) % 4
            pad[bb, c, off:off + seg.numel()] = seg * seg
    rounds = pad.view(b, spans, words // 128, 32, 4)
    acc = torch.zeros((b, spans, 32, 4))
    for r in range(rounds.shape[2]):
        acc = acc + rounds[:, :, r]
    lanes = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    part = _butterfly(lanes)                  # (B, spans)
    per_lane = torch.zeros((b, -(-spans // 32) * 32))
    per_lane[:, :spans] = part
    ss = torch.zeros((b, 32))
    for r in range(per_lane.shape[1] // 32):
        ss = ss + per_lane[:, 32 * r:32 * (r + 1)]
    scale = torch.clamp(clip / torch.clamp(torch.sqrt(_butterfly(ss)),
                                           min=1e-12), max=1.0)
    col = torch.zeros(n, dtype=torch.float64)
    for bb in range(b):                       # fmaf: exact product, one rounding
        col = (scale[bb].double() * x[bb].double() + col).float().double()
    return (noise_scale * z.double() + col).float()


@pytest.mark.parametrize("b,n", [(5, 16385), (3, 300001), (6, 8193),
                                 (2, 3)])
@pytest.mark.parametrize("clip,noise_scale", [(0.5, 0.0), (0.5, 0.7),
                                              (1e6, 1.3)])
def test_dp_clip_kernel_numerics_match_jax(b, n, clip, noise_scale):
    """The redesigned kernel's order of sums, emulated, at odd N (rows that
    start off a 16-byte boundary), across span edges and with more spans
    than lanes, and with an all-zero row, within the dp_clip op's
    tolerance of the JAX reference."""
    x, z = _stack(b, n, seed=b * 31 + n)
    x[b // 2] = 0.0
    want = jdp_clip_noise_ref(jnp.asarray(x), clip, noise_scale,
                              jnp.asarray(z))
    got = _dp_clip_emulation(torch.tensor(x), clip, noise_scale,
                             torch.tensor(z))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# per-example gradients and the DP-SGD step
# ---------------------------------------------------------------------------

def _d_setup(b=6, seed=0):
    jc = JDCGANConfig(base_filters=8)
    jparams = jax.tree.map(np.asarray, jdisc_init(jax.random.PRNGKey(seed),
                                                  jc))
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    fake = np.tanh(rng.standard_normal((b, 28, 28, 1))).astype(np.float32)
    return jc, DCGANConfig(base_filters=8), jparams, real, fake


def test_per_example_grads_match_jax():
    """torch.func.vmap(grad_and_value) over singleton batches against
    jax.vmap(value_and_grad): losses at 1e-5, each leaf's per-example
    gradients at 1e-5 of that leaf's largest magnitude (BN-fed biases: of
    the largest gradient element of any leaf).  Every example's gradient
    norm exceeds the trainer tests' DP clip of 0.1."""
    jc, c, jparams, real, fake = _d_setup()

    def jone(p, r, f):
        return jd_loss_fn(p, r[None], f[None], jc)

    jl, jg = jax.vmap(jax.value_and_grad(jone), in_axes=(None, 0, 0))(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(real),
        jnp.asarray(fake))
    loss_fn = functools.partial(d_loss_fn, c=c)
    tg, tl = torch.func.vmap(
        torch.func.grad_and_value(lambda p, r, f: loss_fn(p, r[None],
                                                           f[None])),
        in_dims=(None, 0, 0))(params_from_numpy(jparams, "cpu"),
                              torch.tensor(real), torch.tensor(fake))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    top = max(float(np.abs(np.asarray(w)).max())
              for w in jax.tree.leaves(jg))
    for path, g, w in zip(_paths(tg), leaves(tg), jax.tree.leaves(jg)):
        w = np.asarray(w)
        scale = top if path[-2:] in BN_FED_BIASES else np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * scale,
                                   err_msg=str(path))
    norms = np.sqrt(sum(np.sum(np.asarray(w).reshape(w.shape[0], -1) ** 2,
                               axis=1) for w in jax.tree.leaves(jg)))
    assert norms.min() > 0.1


def test_dp_step_matches_jax_without_noise():
    """One DP-SGD step (clip binding, noise off) against the JAX step:
    parameters at 1e-6, BN-fed biases within lr of their start."""
    jc, c, jparams, real, fake = _d_setup(b=5, seed=1)
    ocfg = dict(name="adam", lr=2e-4, beta1=0.5, beta2=0.999)
    jopt = jmake_optimizer(JOptimConfig(**ocfg))
    topt = make_optimizer(OptimConfig(**ocfg))
    jstep = jdef.make_dp_d_step(
        jopt, functools.partial(jd_loss_fn, c=jc), 2e-4, 0.1, 0.0)
    tstep = tdef.make_dp_d_step(
        topt, functools.partial(d_loss_fn, c=c), 2e-4, 0.1, 0.0)
    jp = jax.tree.map(jnp.asarray, jparams)
    jp2, _, jl = jstep(jp, jopt.init(jp), jnp.asarray(real),
                       jnp.asarray(fake), jax.random.PRNGKey(0))
    tp = params_from_numpy(jparams, "cpu")
    tp2, _, tl = tstep(tp, topt.init(tp), torch.tensor(real),
                       torch.tensor(fake), keys.root(keys.DP_SGD, 0))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for path, g, w, s in zip(_paths(tp2), leaves(tp2), jax.tree.leaves(jp2),
                             jax.tree.leaves(jparams)):
        if path[-2:] in BN_FED_BIASES:
            for side in (g.numpy(), np.asarray(w)):
                np.testing.assert_allclose(side, s, rtol=0, atol=2e-4)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6, err_msg=str(path))


# ---------------------------------------------------------------------------
# DP-SGD through the executed split: the per-example staged step
# ---------------------------------------------------------------------------

# the plan of 2 devices (capacities 2, 2; time factors 1, 2) that
# sorted_single cuts into 4 segments: 3 boundaries, every layer alone
SPLIT_DEVICES = ([2, 2], [1.0, 2.0])
LOSSY = ("int8", "fp16", "topk")


def _split_execs(name, sigma=0.0, k=1, use_kernel=False):
    """The port's and the JAX executor of the same plan and stage."""
    costs = disc_layer_costs(JDCGANConfig(base_filters=8))
    layers = [(n, costs[n]) for n in disc_layer_names(
        JDCGANConfig(base_filters=8))]
    devs = list(zip(*SPLIT_DEVICES))
    plan = make_plan(Client("c0", [Device(f"d{i}", tf, cap) for i, (cap, tf)
                                   in enumerate(devs)]),
                     layers, "sorted_single", 3)
    jplan = jmake_plan(JClient("c0", [JDevice(f"d{i}", tf, cap) for i,
                                      (cap, tf) in enumerate(devs)]),
                       layers, "sorted_single", 3)
    base = dict(enabled=True, stage_clip=1.0, stage_sigma=sigma,
                topk_frac=0.1)
    ex = ts.SplitExecution(
        plan, functools.partial(disc_apply_layer,
                                c=DCGANConfig(base_filters=8)),
        (functools.partial(bce_logits, target=1.0),
         functools.partial(bce_logits, target=0.0)),
        stage=ts.make_boundary_stage(SplitConfig(
            **base, use_kernel=use_kernel), name),
        pipeline_microbatches=k)
    jex = js.SplitExecution(
        jplan, functools.partial(jdisc_apply_layer,
                                 c=JDCGANConfig(base_filters=8)),
        (functools.partial(jbce_logits, target=1.0),
         functools.partial(jbce_logits, target=0.0)),
        stage=js.make_boundary_stage(JSplitConfig(**base), name),
        pipeline_microbatches=k)
    assert ex.num_boundaries == 3
    return ex, jex


def _assert_tree_close(got, want, tol):
    """Each leaf within ``tol`` of its largest magnitude; the BN-fed
    biases of the whole tree's largest."""
    want = [np.asarray(w) for w in want]
    top = max(float(np.abs(w).max()) for w in want)
    for path, g, w in zip(_paths(got), leaves(got), want):
        scale = top if path[-2:] in BN_FED_BIASES else np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * scale,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", ["identity", "fp16", "dp", "int8+dp"])
def test_per_example_split_grads_match_jax(name):
    """The batched per-example staged step against ``jax.vmap`` of the
    JAX executor's step on batches of one (stage noise off): losses at
    1e-5, gradients at 1e-5 of each leaf's largest.  Through fp16, 1e-3
    for both: a quantum that flips between frameworks at a crossing of
    ONE example is not diluted by a batch mean (at this input one fp16
    flip moves an example's loss by 4e-5 and its classifier-bias
    gradient by 1.3e-4 of the leaf's largest).  Through int8, one quantum:
    the classifier's weight gradient is its input times one number, so a
    flipped input element (1/127 of the crossing's amax) moves it by up to
    1/127 of the leaf's largest."""
    jc, c, jparams, real, fake = _d_setup(b=5, seed=3)
    ex, jex = _split_execs(name)
    jp = jax.tree.map(jnp.asarray, jparams)
    jl, jg = jax.vmap(lambda r, f: jex.value_and_grad(
        jp, r[None], f[None], jax.random.PRNGKey(0)))(jnp.asarray(real),
                                                        jnp.asarray(fake))
    tl, tg = ex.per_example_value_and_grad(
        params_from_numpy(jparams, "cpu"), torch.tensor(real),
        torch.tensor(fake), keys.root(keys.DP_SGD, 0))
    assert tl.shape == (5,)
    tol = {"int8": 1 / 127, "fp16": 1e-3}.get(name.split("+")[0], 1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol)
    _assert_tree_close(tg, jax.tree.leaves(jg), tol)


@pytest.mark.parametrize("name", ["identity", "int8+dp"])
def test_dp_split_step_matches_jax_without_noise(name):
    """One DP-SGD step through the split (clip binding, noise off) against
    the JAX ``make_local_step`` with the JAX executor.  SGD at lr 1 makes
    the step's update the privatized mean gradient itself (Adam's first
    step would map each element to +-lr, blowing up the rounding noise of
    near-zero elements).  The update, read back as params - new params,
    is held to ``tol`` of each leaf's largest plus 4 ulp of the leaf's
    largest parameter (the read-back's rounding); ``tol`` is 1e-5, and
    1e-3 through int8 (a quantum that flips in one example, 1/127 of its
    crossing's amax, reaches the classifier's gradient through the mean
    over 5 clipped examples).  The loss at 1e-5 (1e-3 through int8)."""
    jc, c, jparams, real, fake = _d_setup(b=5, seed=1)
    ex, jex = _split_execs(name)
    ocfg = dict(name="sgd", lr=1.0, beta1=0.0, grad_clip=0.0)
    jopt = jmake_optimizer(JOptimConfig(**ocfg))
    topt = make_optimizer(OptimConfig(**ocfg))
    priv = dict(enabled=True, mode="dp_sgd", clip_norm=0.1,
                noise_multiplier=0.0)
    jstep = jmake_local_step(jopt, functools.partial(jd_loss_fn, c=jc),
                             JPrivacyConfig(**priv), split_exec=jex)
    tstep = make_local_step(topt, functools.partial(d_loss_fn, c=c),
                            PrivacyConfig(**priv), split_exec=ex)
    jp = jax.tree.map(jnp.asarray, jparams)
    jp2, _, jl = jstep(jp, jopt.init(jp), jnp.asarray(real),
                       jnp.asarray(fake), 1.0, jax.random.PRNGKey(0))
    tp = params_from_numpy(jparams, "cpu")
    tp2, _, tl = tstep(tp, topt.init(tp), torch.tensor(real),
                       torch.tensor(fake), 1.0, keys.root(keys.DP_SGD, 0))
    tol = 1e-5 if name == "identity" else 1e-3
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol)
    starts = jax.tree.leaves(jparams)
    want = [s - np.asarray(w) for s, w in zip(starts, jax.tree.leaves(jp2))]
    top = max(float(np.abs(w).max()) for w in want)
    for path, s, a, w in zip(_paths(tp2), starts, leaves(tp2), want):
        scale = top if path[-2:] in BN_FED_BIASES else np.abs(w).max()
        np.testing.assert_allclose(
            s - a.numpy(), w, rtol=0, err_msg=str(path),
            atol=tol * scale + 4 * np.spacing(np.abs(s).max()))


@pytest.mark.parametrize("name", ["identity", "int8", "topk", "dp",
                                  "int8+dp", "fp16+dp", "topk+dp"])
@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_batched_per_example_step_matches_the_loop_oracle(name, sigma):
    """The batched form (vmap per segment, each crossing's stage once on
    the whole batch) against the loop over examples through ``run``, with
    the same noise (row i of each crossing's draw): losses at 1e-5,
    gradients at 1e-5 of each leaf's largest; through a codec both at
    1e-4 (the batched convolutions sum in another order, ~2e-7, which can
    flip one quantum)."""
    _, _, jparams, real, fake = _d_setup(b=6, seed=5)
    ex, _ = _split_execs(name, sigma)
    params = params_from_numpy(jparams, "cpu")
    r, f = torch.tensor(real), torch.tensor(fake)
    key = keys.fold_in(keys.root(keys.DP_SGD, 2), 0, 1)
    bl, bg = ex.per_example_value_and_grad(params, r, f, key)
    ol, og = ex.per_example_oracle(params, r, f, key)
    tol = 1e-4 if name.split("+")[0] in LOSSY else 1e-5
    np.testing.assert_allclose(bl.numpy(), ol.numpy(), rtol=tol)
    _assert_tree_close(bg, leaves(og), tol)
    if sigma and ex.stochastic:
        other, _ = ex.per_example_value_and_grad(
            params, r, f, keys.fold_in(key, 9))
        assert not torch.equal(other, bl)


def _dp_step(ex, noise, use_kernel=False):
    c = DCGANConfig(base_filters=8)
    opt = make_optimizer(OptimConfig(name="adam", lr=2e-4, beta1=0.5,
                                     beta2=0.999))
    step = make_local_step(
        opt, functools.partial(d_loss_fn, c=c),
        PrivacyConfig(enabled=True, mode="dp_sgd", clip_norm=0.1,
                      noise_multiplier=noise, use_kernel=use_kernel),
        split_exec=ex)
    return step, opt


def test_dp_split_with_the_identity_stage_matches_dp_without_split():
    """Noise on (the same dp_clip draw from the same key): the parameters
    after one Adam step at 1e-6, BN-fed biases within lr of their start;
    the loss at 1e-6."""
    _, _, jparams, real, fake = _d_setup(b=6, seed=2)
    ex, _ = _split_execs("identity")
    params = params_from_numpy(jparams, "cpu")
    key = keys.root(keys.DP_SGD, 4)
    out = []
    for split in (ex, None):
        step, opt = _dp_step(split, 1.0)
        out.append(step(params, opt.init(params), torch.tensor(real),
                        torch.tensor(fake), 2e-4, key))
    (sp, _, sl), (mp, _, ml) = out
    np.testing.assert_allclose(float(sl), float(ml), rtol=1e-6)
    for path, a, b, s in zip(_paths(sp), leaves(sp), leaves(mp),
                             leaves(params)):
        if path[-2:] in BN_FED_BIASES:
            for side in (a, b):
                np.testing.assert_allclose(side.numpy(), s.numpy(), rtol=0,
                                           atol=2e-4)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("name", ["identity", "int8+dp"])
def test_dp_split_at_k4_equals_k1_bit_for_bit(name):
    """A batch of one is never pipelined (effective_microbatches(1, K) ==
    1), so K = 4 runs the same per-example step: equal bit for bit, noise
    on in both the stage and dp_clip."""
    _, _, jparams, real, fake = _d_setup(b=8, seed=6)
    params = params_from_numpy(jparams, "cpu")
    key = keys.root(keys.DP_SGD, 8)
    out = []
    for k in (4, 1):
        ex, _ = _split_execs(name, 0.5, k=k)
        step, opt = _dp_step(ex, 1.0)
        out.append(step(params, opt.init(params), torch.tensor(real),
                        torch.tensor(fake), 2e-4, key))
    (p4, o4, l4), (p1, o1, l1) = out
    assert torch.equal(l4, l1)
    for a, b in zip(leaves(p4) + leaves(o4), leaves(p1) + leaves(o1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the RDP accountant (the reference's own math)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [1.0, 0.01, 0.25])
@pytest.mark.parametrize("sigma", [0.5, 1.0, 3.7])
def test_rdp_matches_reference(q, sigma):
    for order in (1.5, 2, 2.75, 7, 32, 40.5, 128):
        assert tdef.rdp_sampled_gaussian(q, sigma, order) == \
            jdef.rdp_sampled_gaussian(q, sigma, order)
    for steps in (1, 24, 480):
        assert tdef.dp_epsilon(sigma, q, steps) == \
            jdef.dp_epsilon(sigma, q, steps)


def test_accountant_matches_reference_with_changing_sigma():
    ta, ja = tdef.RDPAccountant(1.1, 0.05), jdef.RDPAccountant(1.1, 0.05)
    for n, s in ((3, None), (10, 0.8), (0, 0.0), (5, 2.0)):
        ta.step(n, noise_multiplier=s)
        ja.step(n, noise_multiplier=s)
        assert ta.epsilon(1e-5) == ja.epsilon(1e-5)
        assert ta.projected_epsilon(7) == ja.projected_epsilon(7)
    assert ta.steps == ja.steps == 18


@pytest.mark.parametrize("eps,steps,q", [(1.0, 100, 0.01), (8.0, 24, 1.0),
                                         (3.0, 1000, 0.05)])
def test_sigma_inversion_matches_reference(eps, steps, q):
    s = tdef.sigma_for_epsilon(eps, steps, sample_rate=q)
    assert s == jdef.sigma_for_epsilon(eps, steps, sample_rate=q)
    assert tdef.dp_epsilon(s, q, steps) <= eps
    feasible = lambda x: x >= 2.5  # noqa: E731
    assert tdef.min_feasible_sigma(feasible, 0.1, 10.0) == \
        jdef.min_feasible_sigma(feasible, 0.1, 10.0)


# ---------------------------------------------------------------------------
# the uplink DP stage
# ---------------------------------------------------------------------------

def _delta(seed, scale):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((4, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(9) * scale).astype(np.float32)}}


@pytest.mark.parametrize("scale", [0.001, 1.0])
def test_uplink_stage_clips_like_jax_without_noise(scale):
    d = _delta(0, scale)
    got = tdef.DPUplinkStage(0.5, 0.0)("c0", params_from_numpy(d, "cpu"))
    want = jdef.DPUplinkStage(0.5, 0.0)("c0", jax.tree.map(jnp.asarray, d))
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    norm = float(np.sqrt(sum(np.sum(g.numpy().astype(np.float64) ** 2)
                             for g in leaves(got))))
    raw = float(np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                            for x in jax.tree.leaves(d))))
    np.testing.assert_allclose(norm, min(raw, 0.5), rtol=1e-6)


def test_uplink_stage_noise_is_a_function_of_seed_client_and_round():
    d = params_from_numpy(_delta(1, 1.0), "cpu")
    a, b = tdef.DPUplinkStage(1.0, 0.7, seed=3), tdef.DPUplinkStage(
        1.0, 0.7, seed=3)
    a0, b0 = a("c0", d), b("c0", d)
    a1 = a("c1", d)                      # another client
    a0r1, b1 = a("c0", d), b("c1", d)    # c0's second round; c1 in b
    assert all(torch.equal(x, y) for x, y in zip(leaves(a0), leaves(b0)))
    assert all(torch.equal(x, y) for x, y in zip(leaves(a1), leaves(b1)))
    assert not torch.equal(leaves(a0)[0], leaves(a1)[0])
    assert not torch.equal(leaves(a0)[0], leaves(a0r1)[0])
    c0 = tdef.DPUplinkStage(1.0, 0.7, seed=4)("c0", d)
    assert not torch.equal(leaves(a0)[0], leaves(c0)[0])


def test_make_uplink_stage_only_in_uplink_mode():
    assert tdef.make_uplink_stage(None) is None
    assert tdef.make_uplink_stage(PrivacyConfig(enabled=False,
                                                mode="uplink")) is None
    assert tdef.make_uplink_stage(PrivacyConfig(enabled=True)) is None
    st = tdef.make_uplink_stage(PrivacyConfig(
        enabled=True, mode="uplink", clip_norm=0.3, noise_multiplier=2.0,
        seed=9))
    assert (st.clip_norm, st.noise_multiplier, st.seed) == (0.3, 2.0, 9)


# ---------------------------------------------------------------------------
# in-port pins
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parts():
    imgs, labels = synthetic_mnist(120, seed=0)
    return partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)


def _trainer(parts, over):
    return FSLGANTrainer(get_config("dcgan-mnist").override(
        {**SMALL, **over}), parts, seed=0, device="cpu")


def _assert_same_state(ta, tb):
    for cid in ta.state.d_params:
        for a, b in zip(leaves(ta.state.d_params[cid]),
                        leaves(tb.state.d_params[cid])):
            assert torch.equal(a, b)
    for a, b in zip(leaves(ta.state.g_params), leaves(tb.state.g_params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("over", [
    {**DP, "privacy.noise_multiplier": 0.0},
    {**DP, "privacy.noise_multiplier": 1.0},
    {"privacy.enabled": True, "privacy.mode": "uplink",
     "privacy.clip_norm": 0.01, "privacy.noise_multiplier": 1.0},
], ids=["dp_sgd", "dp_sgd_noisy", "uplink_noisy"])
def test_engine_equals_sequential_bit_for_bit(parts, over):
    """The engine's round is the sequential loop under DP-SGD and uplink
    DP: the same step definition, the same noise key paths."""
    ta, tb = _trainer(parts, over), _trainer(parts, over)
    for _ in range(2):
        ma = ta.train_epoch(batches_per_client=BATCHES)
        mb = tb.train_epoch_sequential(batches_per_client=BATCHES)
        for k in ("d_loss", "g_loss", "num_clients", "dp_epsilon"):
            assert ma[k] == mb[k], k
    _assert_same_state(ta, tb)
    assert ta.accountant.steps == tb.accountant.steps


def test_noisy_dp_sgd_runs_repeat_bit_for_bit(parts):
    """With noise on, a seed fixes the run; another seed changes it."""
    over = {**DP, "privacy.noise_multiplier": 1.0, "privacy.seed": 7}
    ta, tb = _trainer(parts, over), _trainer(parts, over)
    tc = _trainer(parts, {**over, "privacy.seed": 8})
    for _ in range(2):
        ma = ta.train_epoch(batches_per_client=1)
        assert ma == tb.train_epoch(batches_per_client=1)
        tc.train_epoch(batches_per_client=1)
    _assert_same_state(ta, tb)
    assert not torch.equal(leaves(ta.state.d_params["c0"])[0],
                           leaves(tc.state.d_params["c0"])[0])


TIMES = ("round_time_s", "clock_s")
SPLIT_DP = {**DP, "privacy.noise_multiplier": 1.0, "split.enabled": True,
            "split.boundary_stage": "int8+dp", "split.stage_sigma": 0.5}


def test_dp_split_rounds_repeat_and_k4_equals_k1(parts):
    """DP-SGD through the split, noise on in the stage and in dp_clip: a
    seed fixes the run, K = 4 trains as K = 1 bit for bit (only the
    virtual round time differs: it is priced pipelined), epsilon grows as
    the accountant's, and the LAN bytes are the split's measured ones."""
    ta, tb = _trainer(parts, SPLIT_DP), _trainer(parts, SPLIT_DP)
    tk = _trainer(parts, {**SPLIT_DP, "split.pipeline_microbatches": 4})
    assert all(ex.pipeline_microbatches == 4
               for ex in tk.split_execs.values())
    eps = []
    for _ in range(2):
        ma = ta.train_epoch(batches_per_client=1)
        assert ma == tb.train_epoch(batches_per_client=1)
        mk = tk.train_epoch(batches_per_client=1)
        # K prices the round by the 1F1B schedule, as in the reference
        assert mk["round_time_s"] < ma["round_time_s"]
        assert {k: v for k, v in mk.items() if k not in TIMES} == \
            {k: v for k, v in ma.items() if k not in TIMES}
        eps.append(ma["dp_epsilon"])
    _assert_same_state(ta, tb)
    _assert_same_state(ta, tk)
    acct = tdef.RDPAccountant(1.0, 1.0)
    acct.step(2 * len(ta.client_ids))
    assert eps[1] > eps[0] > 0 and eps[1] == acct.epsilon(1e-5)[0]
    want = sum(ex.step_wire_bytes(ta.state.d_params[cid], (8, 28, 28, 1))[0]
               for cid, ex in ta.split_execs.items())
    assert ma["lan_mbytes"] == want / 1e6


def test_dp_epsilon_grows_with_rounds(parts):
    tr = _trainer(parts, {**DP, "privacy.noise_multiplier": 1.0})
    eps = [tr.train_epoch(batches_per_client=1)["dp_epsilon"]
           for _ in range(2)]
    assert np.isfinite(eps).all() and eps[1] > eps[0] > 0
    acct = tdef.RDPAccountant(1.0, 1.0)
    acct.step(2 * len(tr.client_ids))
    assert eps[1] == acct.epsilon(1e-5)[0]


# ---------------------------------------------------------------------------
# the CUDA kernel (GPU only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(1, 1), (1, 4097), (256, 4097),
                                 (3, 4096), (256, 16865)])
@pytest.mark.parametrize("noise_scale", [0.0, 0.9])
def test_kernel_matches_plain_version_on_gpu(cuda, b, n, noise_scale):
    x, z = _stack(b, n, seed=n + b)
    xs, zs = torch.tensor(x, device=cuda), torch.tensor(z, device=cuda)
    before = dp_clip_noise_kernel.launches
    got = dp_clip_noise_kernel(xs, 0.5, noise_scale, zs)
    torch.cuda.synchronize()
    assert dp_clip_noise_kernel.launches == before + 1
    want = dp_clip_noise_ref(xs, 0.5, noise_scale, zs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    again = dp_clip_noise_kernel(xs, 0.5, noise_scale, zs)
    assert torch.equal(got, again)      # a fixed summation order


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(1, 8193), (33, 16385), (300, 4097),
                                 (3, 300001), (2, 3)])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_kernel_span_tile_and_alignment_edges_on_gpu(cuda, b, n, offset):
    """N past a span edge and not a multiple of 4, more rows than a
    column tile's stages, a stack whose address is 4 or 12 bytes off a
    16-byte boundary (every row starts unaligned), an all-zero row."""
    x, z = _stack(b, n, seed=n + b + offset)
    x[b // 2] = 0.0
    buf = torch.zeros(b * n + offset, device=cuda)
    xs = buf[offset:].view(b, n)
    xs.copy_(torch.tensor(x))
    zs = torch.tensor(z, device=cuda)
    got = dp_clip_noise_kernel(xs, 0.5, 0.9, zs)
    torch.cuda.synchronize()
    want = dp_clip_noise_ref(xs, 0.5, 0.9, zs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, dp_clip_noise_kernel(xs, 0.5, 0.9, zs))


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.ones((3, 8), device=cuda)
    z = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        dp_clip_noise_kernel(x.double(), 1.0, 0.0, z)
    with pytest.raises(ValueError):
        dp_clip_noise_kernel(x.t(), 1.0, 0.0, torch.zeros(3, device=cuda))
    with pytest.raises(ValueError):
        dp_clip_noise_kernel(x, 1.0, 0.0, z[:4])
    with pytest.raises(ValueError):
        dp_clip_noise_kernel(x[:, :0].contiguous(), 1.0, 0.0, z[:0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["int8+dp", "fp16+dp", "none+dp"])
def test_per_example_split_step_launches_one_kernel_a_crossing_on_gpu(
        cuda_fp32, name):
    """The batched per-example staged step on the card: ONE boundary_fuse
    launch (amax="row") a crossing for the whole batch — 2 passes x 2
    directions x 3 boundaries = 12 — and one dp_clip launch a DP step;
    held against the loop oracle (which launches a kernel per example).
    cuDNN may take other convolution algorithms for the batched and the
    single-example shapes (~1e-5 relative), and through a codec that can
    flip a quantum in one example: losses and gradients (of each leaf's
    largest) at 1e-4, through fp16 at 1e-3, through int8 the gradients at
    one quantum, 1/127 (test_per_example_split_grads_match_jax says
    why)."""
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    _, _, jparams, real, fake = _d_setup(b=16, seed=7)
    ex, _ = _split_execs(name, 0.5, use_kernel=True)
    params = params_from_numpy(jparams, cuda_fp32)
    r = torch.tensor(real, device=cuda_fp32)
    f = torch.tensor(fake, device=cuda_fp32)
    key = keys.root(keys.DP_SGD, 3)
    before = boundary_fuse_kernel.launches
    bl, bg = ex.per_example_value_and_grad(params, r, f, key)
    assert boundary_fuse_kernel.launches - before == 12
    ol, og = ex.per_example_oracle(params, r, f, key)
    assert boundary_fuse_kernel.launches - before == 12 + 16 * 12
    codec = name.split("+")[0]
    np.testing.assert_allclose(bl.cpu().numpy(), ol.cpu().numpy(),
                               rtol=1e-4 if codec == "none" else 1e-3)
    _assert_tree_close(tree_map(torch.Tensor.cpu, bg),
                       [g.cpu() for g in leaves(og)],
                       {"int8": 1 / 127, "fp16": 1e-3}.get(codec, 1e-4))
    step, opt = _dp_step(ex, 1.0, use_kernel=True)
    b0, d0 = boundary_fuse_kernel.launches, dp_clip_noise_kernel.launches
    p2, _, _ = step(params, opt.init(params), r, f, 2e-4, key)
    assert (boundary_fuse_kernel.launches - b0,
            dp_clip_noise_kernel.launches - d0) == (12, 1)
    assert all(bool(torch.isfinite(l).all()) for l in leaves(p2))
