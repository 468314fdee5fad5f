"""The port's privacy attacks (``repro_torch/privacy/attacks.py``) and the
split's boundary hook held against the JAX package on the CPU.

Inputs come from numpy seeds and the discriminator's parameters from the
JAX init through ``repro_torch.bridge``.  The random starts the reference
draws from ``jax.random`` cannot be reproduced, so the port is given the
same start: ``x0`` for the gradient inversion, the JAX decoder's initial
parameters for the activation inversion.  Tolerances: the flat views
1e-6 (the total variation, a float32 mean summed in another order, 1e-5);
the gradient inversion's history (rtol) and reconstruction (atol)
1e-4 over 10 Adam steps (Adam amplifies rounding, so the steps are few);
the decoder 1e-5; its training 1e-4 over 5 steps; a boundary tensor that
went through int8 one quantum of its scale.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import cuda_fp32, one_thread  # noqa: F401

from repro.config import DCGANConfig as JDCGANConfig
from repro.core import split as js
from repro.core.devices import Client as JClient
from repro.core.devices import Device as JDevice
from repro.core.gan import bce_logits as jbce_logits
from repro.core.gan import d_loss_fn as jd_loss_fn
from repro.core.selection import make_plan as jmake_plan
from repro.fed.transport import make_codec as jmake_codec
from repro.kernels.dp_clip.ops import dp_clip_noise_tree as jdp_clip_noise_tree
from repro.models.dcgan import disc_apply_layer as jdisc_apply_layer
from repro.models.dcgan import disc_init as jdisc_init
from repro.models.dcgan import disc_layer_costs, disc_layer_names
from repro.privacy import attacks as ja
from repro.privacy import metrics as jm
from repro_torch import keys
from repro_torch.bridge import params_from_numpy
from repro_torch.config import DCGANConfig
from repro_torch.core import split as ts
from repro_torch.core.devices import Client, Device
from repro_torch.core.gan import bce_logits, d_loss_fn
from repro_torch.core.selection import make_plan
from repro_torch.data import synthetic_mnist
from repro_torch.examples.privacy_frontier_demo import per_example_grads
from repro_torch.fed.transport import make_codec
from repro_torch.kernels.dp_clip.ops import dp_clip_noise_tree
from repro_torch.models.dcgan import disc_apply, disc_apply_layer
from repro_torch.privacy import attacks as ta
from repro_torch.privacy import (distance_correlation, membership_inference,
                                 psnr)
from repro_torch.tree import leaves


JC, C = JDCGANConfig(base_filters=8), DCGANConfig(base_filters=8)
CPU = torch.device("cpu")
# the activation shapes of the D's three conv boundaries at base_filters 8
ACT_SHAPES = [(14, 14, 8), (7, 7, 16), (4, 4, 32)]


@pytest.fixture(scope="module")
def d_params():
    """(JAX params as numpy, the same params as CPU tensors)."""
    jp = jax.tree.map(np.asarray, jdisc_init(jax.random.PRNGKey(0), JC))
    return jp, params_from_numpy(jp, CPU)


def _images(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return np.tanh(scale * rng.standard_normal((n, 28, 28, 1))).astype(
        np.float32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# gradient inversion
# ---------------------------------------------------------------------------

def test_flat_views_match_jax(d_params):
    jp, tp = d_params
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
    np.testing.assert_array_equal(
        _np(ta.flat_grads(params_from_numpy(tree, CPU))),
        np.asarray(ja.flat_grads(tree)))
    want = ja.delta_to_grad(tree, 2e-4)
    got = ta.delta_to_grad(params_from_numpy(tree, CPU), 2e-4)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6)
    # a float32 mean of 2,268 terms, summed in another order: 1e-5
    x = _images(3, 2)
    np.testing.assert_allclose(
        float(ta._total_variation(torch.tensor(x))),
        float(ja._total_variation(jnp.asarray(x))), rtol=1e-5)


@pytest.mark.parametrize("tv_weight", [1e-3, 0.0])
def test_invert_gradients_matches_jax(d_params, tv_weight):
    jp, tp = d_params
    real, fake = _images(1, 3), 0.3 * _images(1, 4)
    x0 = (0.1 * np.random.default_rng(5).standard_normal(
        (1, 28, 28, 1))).astype(np.float32)
    jloss = functools.partial(jd_loss_fn, c=JC)
    g = jax.tree.map(np.asarray, jax.grad(jloss)(jp, jnp.asarray(real),
                                                 jnp.asarray(fake)))
    want_x, want_h = ja.invert_gradients(jloss, jp, g, jnp.asarray(fake),
                                         (1, 28, 28, 1), steps=10,
                                         tv_weight=tv_weight, x0=x0)
    got_x, got_h = ta.invert_gradients(
        functools.partial(d_loss_fn, c=C), tp, params_from_numpy(g, CPU),
        fake, (1, 28, 28, 1), steps=10, tv_weight=tv_weight, x0=x0)
    np.testing.assert_allclose(got_h, want_h, rtol=1e-4)
    np.testing.assert_allclose(_np(got_x), np.asarray(want_x), atol=1e-4)
    assert got_h[-1] < got_h[0]               # the attack makes progress
    # the parameters it was given are left as they were
    assert not any(l.requires_grad for l in leaves(tp))


def test_invert_gradients_draws_its_start_from_the_key(d_params):
    _, tp = d_params
    loss = functools.partial(d_loss_fn, c=C)
    real, fake = torch.tensor(_images(1, 3)), torch.tensor(_images(1, 4))
    g = torch.func.grad(loss)(tp, real, fake)
    a, _ = ta.invert_gradients(loss, tp, g, fake, (1, 28, 28, 1), steps=1,
                               key=keys.root(keys.DEFAULT, 7))
    b, _ = ta.invert_gradients(loss, tp, g, fake, (1, 28, 28, 1), steps=1,
                               key=keys.root(keys.DEFAULT, 7))
    c, _ = ta.invert_gradients(loss, tp, g, fake, (1, 28, 28, 1), steps=1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= 1.0


def test_defended_gradient_clip_only_matches_jax(d_params):
    """The re-attack's privatized gradient with the noise off: per-example
    gradients through ``torch.func`` and the dp_clip op's clip + sum."""
    jp, tp = d_params
    real, fake = _images(3, 6), 0.3 * _images(3, 7)
    jloss = functools.partial(jd_loss_fn, c=JC)
    per_ex = jax.vmap(lambda r, f: jax.grad(jloss)(jp, r[None], f[None]))(
        jnp.asarray(real), jnp.asarray(fake))
    want = jdp_clip_noise_tree(per_ex, 1.0, 0.0, jax.random.PRNGKey(11),
                               use_kernel=False)
    got = dp_clip_noise_tree(
        per_example_grads(functools.partial(d_loss_fn, c=C), tp,
                          torch.tensor(real), torch.tensor(fake)),
        1.0, 0.0, keys.root(keys.DEFAULT, 11), use_kernel=True)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the decoder and the activation inversion
# ---------------------------------------------------------------------------

def _jdecoder(act_shape, width=8):
    layers, sizes = ja._decoder_init(jax.random.PRNGKey(3), act_shape,
                                     (28, 28, 1), width)
    return [jax.tree.map(np.asarray, l) for l in layers], sizes


@pytest.mark.parametrize("act_shape", ACT_SHAPES)
def test_decoder_init_sizes_match_jax(act_shape):
    want, want_sizes = _jdecoder(act_shape, width=32)
    got, sizes = ta._decoder_init(torch.Generator().manual_seed(0),
                                  act_shape, (28, 28, 1), 32)
    assert sizes == want_sizes
    assert sizes == {14: (28, 28), 7: (14, 28, 28),
                     4: (8, 16, 28, 28)}[act_shape[0]]
    assert list(got) == list(range(len(want)))
    for i, w in enumerate(want):
        assert {k: tuple(v.shape) for k, v in got[i].items()} \
            == {k: v.shape for k, v in w.items()}


@pytest.mark.parametrize("act_shape", ACT_SHAPES)
def test_decoder_apply_matches_jax(act_shape):
    """The bilinear resizes grow only (14 -> 28, 7 -> 14 -> 28, 4 -> 8 ->
    16 -> 28): there ``jax.image.resize`` and ``F.interpolate`` agree."""
    layers, sizes = _jdecoder(act_shape)
    a = np.random.default_rng(act_shape[0]).standard_normal(
        (3,) + act_shape).astype(np.float32)
    want = ja._decoder_apply(layers, sizes, jnp.asarray(a))
    got = ta._decoder_apply(params_from_numpy(dict(enumerate(layers)), CPU),
                            sizes, torch.tensor(a))
    assert got.shape == (3, 28, 28, 1)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("depth", [1, 3])
def test_activation_inversion_training_matches_jax(d_params, depth):
    jp, tp = d_params
    aux = _images(64, 8)
    jatk = ja.ActivationInversionAttack(ja.make_prefix_fn(jp, JC, depth),
                                        (28, 28, 1), width=8, seed=0)
    atk = ta.ActivationInversionAttack(ta.make_prefix_fn(tp, C, depth),
                                       (28, 28, 1), width=8, seed=0,
                                       device="cpu")
    assert atk.act_shape == jatk.act_shape and atk.sizes == jatk.sizes
    atk.dec = params_from_numpy(dict(enumerate(
        jax.tree.map(np.asarray, jatk.dec))), CPU)
    atk._state = atk._opt.init(atk.dec)
    want_h = jatk.train(aux, steps=5, batch=16, seed=2)
    got_h = atk.train(aux, steps=5, batch=16, seed=2)
    np.testing.assert_allclose(got_h, want_h, rtol=1e-4)
    victim = _images(4, 9)
    np.testing.assert_allclose(_np(atk.reconstruct(victim)),
                               np.asarray(jatk.reconstruct(victim)),
                               atol=1e-4)


def test_activation_inversion_leaks_less_with_depth(d_params):
    """Twin of the reference's ``test_activation_inversion_leaks_less_with
    _depth``, at its sizes and pins, on the port."""
    _, tp = d_params
    aux, _ = synthetic_mnist(128, seed=5)
    victim, _ = synthetic_mnist(16, seed=9)
    victim = torch.tensor(victim)
    results = {}
    for depth in (1, 3):
        atk = ta.ActivationInversionAttack(ta.make_prefix_fn(tp, C, depth),
                                           (28, 28, 1), seed=0,
                                           device="cpu")
        hist = atk.train(aux, steps=120, batch=32)
        assert hist[-1] < hist[0]              # the decoder actually learns
        rec = atk.reconstruct(victim)
        assert rec.shape == victim.shape
        results[depth] = {"psnr": psnr(rec, victim),
                          "dcor": distance_correlation(victim,
                                                       atk.prefix(victim))}
    assert results[3]["psnr"] < results[1]["psnr"]
    assert results[3]["dcor"] < results[1]["dcor"]
    assert results[1]["psnr"] > 18.0


# ---------------------------------------------------------------------------
# prefixes, the plan's boundaries, the split's hook
# ---------------------------------------------------------------------------

def _plan(torch_side=True, strategy="sorted_single", seed=3):
    """A plan of 3 boundaries (one a layer) over two devices."""
    costs = disc_layer_costs(JC)
    layers = [(n, costs[n]) for n in disc_layer_names(JC)]
    if torch_side:
        return make_plan(Client("c0", [Device("d0", 1.0, 2),
                                       Device("d1", 2.0, 2)]),
                         layers, strategy, seed)
    return jmake_plan(JClient("c0", [JDevice("d0", 1.0, 2),
                                     JDevice("d1", 2.0, 2)]),
                      layers, strategy, seed)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefix_fn_matches_jax(d_params, depth):
    jp, tp = d_params
    x = _images(4, depth)
    got = ta.make_prefix_fn(tp, C, depth)(x)
    want = ja.make_prefix_fn(jp, JC, depth)(jnp.asarray(x))
    assert got.shape == want.shape and not got.requires_grad
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("strategy", ["sorted_single", "sorted_multi",
                                      "random_single", "random_multi"])
def test_plan_boundary_depths_match_jax(strategy):
    plan = _plan(strategy=strategy)
    assert ta.plan_boundary_depths(plan) == ja.plan_boundary_depths(
        _plan(False, strategy))
    assert len(ta.plan_boundary_depths(plan)) == plan.num_boundaries


def test_split_forward_hook_sees_each_boundary_and_keeps_output(d_params):
    """Twin of the reference's ``test_split_forward_hook_sees_each_boundary
    _and_keeps_output``; and the hook's activations against JAX's."""
    jp, tp = d_params
    plan = make_plan(Client("c0", [Device("d0", 1.0, 2),
                                   Device("d1", 2.0, 2)]),
                     [(n, c_) for n, c_ in disc_layer_costs(JC).items()],
                     "sorted_multi", 0)
    x = torch.tensor(_images(2, 11, scale=2.0))
    apply_layer = lambda n, a: disc_apply_layer(n, tp, a, C)  # noqa: E731
    seen = ts.boundary_activations(x, plan, apply_layer)
    assert len(seen) == plan.num_boundaries
    depths = ta.plan_boundary_depths(plan)
    assert len(depths) == plan.num_boundaries
    for (idx, dev_a, dev_b, act), depth in zip(seen, depths):
        assert dev_a != dev_b
        assert torch.equal(act, ta.make_prefix_fn(tp, C, depth)(x))
    out = ts.split_forward(x, plan, apply_layer,
                           boundary_hook=lambda *a: None)
    assert torch.equal(out, disc_apply(tp, x, C))
    jplan = js.SplitPlan(plan.client_id, [
        js.Portion(p.device_id, p.layer_names, p.cost)
        for p in plan.portions])
    jseen = js.boundary_activations(
        jnp.asarray(x.numpy()), jplan,
        lambda n, a: jdisc_apply_layer(n, jp, a, JC))
    assert [s[:3] for s in seen] == [s[:3] for s in jseen]
    for s, j in zip(seen, jseen):
        np.testing.assert_allclose(_np(s[3]), np.asarray(j[3]), atol=1e-5)


# ---------------------------------------------------------------------------
# the shipped prefix: what the executed split's boundaries carry
# ---------------------------------------------------------------------------

TAILS = (functools.partial(bce_logits, target=1.0),
         functools.partial(bce_logits, target=0.0))
JTAILS = (functools.partial(jbce_logits, target=1.0),
          functools.partial(jbce_logits, target=0.0))


def _exec(stage=None):
    return ts.SplitExecution(_plan(), functools.partial(disc_apply_layer,
                                                        c=C), TAILS,
                             stage=stage)


def _jexec(stage=None):
    return js.SplitExecution(_plan(False), functools.partial(
        jdisc_apply_layer, c=JC), JTAILS, stage=stage)


def _quantum(ex, params, x, b, key=None):
    """int8's quantum at boundary ``b``: the pre-stage tensor's amax / 127,
    that tensor from ``ex``'s own stages upstream under ``key`` (the
    shipped prefix's first call crosses under ``fold_in(key, 0)``)."""
    pre = torch.as_tensor(x)
    if b:
        pre = ex.forward_boundaries(params, pre, key=key, upto=b - 1)[b - 1]
    for n in ex.segments[b][1]:
        pre = ex.apply_layer(n, params, pre)
    return float(pre.abs().max()) / 127.0


@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_shipped_prefix_codec_stage_matches_jax(d_params, codec):
    jp, tp = d_params
    ex = _exec(ts.CodecBoundaryStage(make_codec(codec)))
    jex = _jexec(js.CodecBoundaryStage(jmake_codec(codec)))
    assert ex.num_boundaries == 3 and not ex.stochastic
    x = _images(4, 12, scale=2.0)
    for b in range(ex.num_boundaries):
        got = ta.make_shipped_prefix_fn(ex, tp, b)(x)
        want = ja.make_shipped_prefix_fn(jex, jp, b)(jnp.asarray(x))
        atol = 1e-5 if codec == "identity" else _quantum(ex, tp, x, b) + 1e-5
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol)
        # the shipped tensor is the staged one, not the clean prefix
        clean = ta.make_prefix_fn(tp, C, ex.boundaries[b].depth)(x)
        if codec == "identity":
            assert torch.equal(got, clean)
        else:
            assert not torch.equal(got, clean)


def test_shipped_prefix_defaults_to_noised_tensors(d_params):
    """Twin of the reference's regression: a keyless probe of a stochastic
    stage still ships noised tensors."""
    _, tp = d_params
    ex = _exec(ts.GaussianBoundaryStage(5.0, 1.0))
    real = torch.tensor(_images(4, 13, scale=2.0))
    noised = ta.make_shipped_prefix_fn(ex, tp, 0)(real)
    clean = _exec().forward_boundaries(tp, real)[0]
    assert float((noised - clean).abs().max()) > 0.0


def test_shipped_prefix_draws_fresh_noise_each_call(d_params):
    _, tp = d_params
    ex = _exec(ts.GaussianBoundaryStage(5.0, 1.0))
    x = torch.tensor(_images(4, 14))
    key = keys.root(keys.STAGE, 13)
    a = ta.make_shipped_prefix_fn(ex, tp, 1, key=key)
    b = ta.make_shipped_prefix_fn(ex, tp, 1, key=key)
    first, second = a(x), a(x)
    assert not torch.equal(first, second)     # one draw per crossing
    assert torch.equal(first, b(x)) and torch.equal(second, b(x))
    # call i is forward_boundaries under fold_in(key, i)
    assert torch.equal(second, ex.forward_boundaries(
        tp, x, key=keys.fold_in(key, 1), upto=1)[1])
    # keyless: the split's default key, folded the same way
    keyless = ta.make_shipped_prefix_fn(ex, tp, 0)
    assert torch.equal(keyless(x), ex.forward_boundaries(
        tp, x, key=keys.fold_in(ex._default_key(None), 0), upto=0)[0])


# ---------------------------------------------------------------------------
# membership inference
# ---------------------------------------------------------------------------

def test_membership_scores_and_inference_match_jax(d_params):
    jp, tp = d_params
    member, nonmember = _images(64, 20, scale=2.0), _images(64, 21)
    ms = ta.membership_scores(tp, member, C)
    assert ms.shape == (64,) and ms.dtype == np.float32
    np.testing.assert_allclose(
        ms, ja.membership_scores(jp, jnp.asarray(member), JC), atol=1e-5)
    got = membership_inference(tp, C, member, nonmember)
    ns = ta.membership_scores(tp, nonmember, C)
    # on the port's own scores, the reference's statistics exactly
    adv, thr = jm.attack_advantage(ms, ns)
    assert got["auc"] == jm.attack_auc(ms, ns)
    assert (got["advantage"], got["threshold"]) == (adv, thr)
    want = ja.membership_inference(jp, JC, member, nonmember)
    assert got["auc"] == pytest.approx(want["auc"], abs=1e-3)
    assert got["advantage"] == pytest.approx(want["advantage"], abs=1e-3)


def test_membership_inference_near_chance_on_fresh_discriminator(d_params):
    """Twin of the reference's ``test_membership_inference_near_chance_on
    _fresh_discriminator``."""
    _, tp = d_params
    member, _ = synthetic_mnist(64, seed=0)
    nonmember, _ = synthetic_mnist(64, seed=1)
    out = membership_inference(tp, C, member, nonmember)
    assert 0.25 < out["auc"] < 0.75
    assert 0.0 <= out["advantage"] <= 1.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_shipped_prefix_kernel_matches_plain_on_gpu(cuda_fp32, d_params):
    """The fused int8+dp stage through the boundary_fuse kernel against
    ``split.use_kernel`` off: one launch a crossing, and each boundary
    within one int8 quantum (upstream differences of a few ulp can move a
    value across a rounding edge)."""
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    params = params_from_numpy(d_params[0], cuda_fp32)
    x = torch.tensor(_images(8, 15, scale=2.0), device=cuda_fp32)
    kern = _exec(ts.FusedBoundaryStage("int8", 1.0, 0.5, use_kernel=True))
    plain = _exec(ts.FusedBoundaryStage("int8", 1.0, 0.5))
    key = keys.root(keys.STAGE, 3)
    for b in range(kern.num_boundaries):
        before = boundary_fuse_kernel.launches
        got = ta.make_shipped_prefix_fn(kern, params, b, key=key)(x)
        torch.cuda.synchronize()
        assert boundary_fuse_kernel.launches - before == b + 1
        want = ta.make_shipped_prefix_fn(plain, params, b, key=key)(x)
        assert boundary_fuse_kernel.launches - before == b + 1
        torch.testing.assert_close(got, want, rtol=0, atol=_quantum(
            plain, params, x, b, keys.fold_in(key, 0)) + 1e-5)
