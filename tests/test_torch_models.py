"""The port's DCGAN, losses, optimizer, data, config and tree helpers held
against the JAX package on the CPU, at a small width (base_filters=8).

Inputs are made with numpy from a seed; parameters are bridged from the
JAX init.  Tolerance 1e-5 (absolute and relative): both sides compute in
fp32, and the two frameworks sum convolutions and reductions in different
orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro.config import DCGANConfig as JDCGANConfig
from repro.configs.registry import get_config as jget_config
from repro.core.gan import bce_logits as jbce_logits
from repro.core.gan import d_loss_fn as jd_loss_fn
from repro.core.gan import g_loss_fn as jg_loss_fn
from repro.data import partition_dirichlet as jpartition_dirichlet
from repro.data import synthetic_mnist as jsynthetic_mnist
from repro.models import dcgan as jdcgan
from repro.optim.optimizers import adamw as jadamw
from repro.optim.optimizers import clip_by_global_norm as jclip
from repro.optim.optimizers import sgd as jsgd
from _torch_config import reference_dict
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.config import DCGANConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.gan import bce_logits, d_loss_fn, g_loss_fn
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.models import dcgan
from repro_torch.optim.optimizers import adamw, clip_by_global_norm, sgd
from repro_torch.tree import leaves, tree_map, value_and_grad

TOL = dict(rtol=1e-5, atol=1e-5)
JC = JDCGANConfig(base_filters=8)
C = DCGANConfig(base_filters=8)
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    """(D, G) parameter trees from the JAX init, as numpy."""
    return (_np(jdcgan.disc_init(jax.random.PRNGKey(0), JC)),
            _np(jdcgan.gen_init(jax.random.PRNGKey(1), JC)))


def _images(b, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, 28, 28, 1)).astype(np.float32)


def _z(b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, JC.latent_dim)).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_trees_close(got, want, **tol):
    assert [tuple(l.shape) for l in leaves(got)] == \
        [tuple(l.shape) for l in jax.tree.leaves(want)]
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)


# ---------------------------------------------------------------------------
# trees and the bridge
# ---------------------------------------------------------------------------

def test_leaves_follow_jax_tree_leaves_order(jparams):
    for tree in jparams:
        got = leaves(params_from_numpy(tree, CPU))
        want = jax.tree.leaves(tree)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_bridge_round_trip_is_exact(jparams):
    d, _ = jparams
    back = params_to_numpy(params_from_numpy(d, CPU))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(d)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_tree_map_rejects_mismatched_structure():
    with pytest.raises(ValueError):
        tree_map(lambda a, b: a, {"x": 1, "y": 2}, {"x": 1})


def test_port_init_has_reference_keys_and_shapes(jparams):
    gen = torch.Generator().manual_seed(0)
    for mine, ref in ((dcgan.disc_init(gen, C, CPU), jparams[0]),
                      (dcgan.gen_init(gen, C, CPU), jparams[1])):
        assert jax.tree.structure(params_to_numpy(mine)) == \
            jax.tree.structure(ref)
        assert [tuple(l.shape) for l in leaves(mine)] == \
            [l.shape for l in jax.tree.leaves(ref)]


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,stride", [(28, 2), (14, 2), (7, 2), (28, 1)])
def test_same_pads_match_xla(size, stride):
    want = jax.lax.padtype_to_pads((size,), (5,), (stride,), "SAME")[0]
    assert dcgan._same_pads(size, 5, stride) == tuple(want)


@pytest.mark.parametrize("name", ["conv0", "conv1", "conv2", "classifier"])
def test_disc_apply_layer_matches_jax(jparams, name):
    """Each layer on the input the reference hands it: conv0 sees 28x28,
    conv1 14x14 and conv2 7x7 (the asymmetric SAME paddings)."""
    d, _ = jparams
    x = jnp.asarray(_images(8, 1))
    for n in jdcgan.disc_layer_names(JC):
        if n == name:
            break
        x = jdcgan.disc_apply_layer(n, d, x, JC)
    want = jdcgan.disc_apply_layer(name, d, x, JC)
    got = dcgan.disc_apply_layer(name, params_from_numpy(d, CPU), _t(x), C)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_disc_apply_matches_jax(jparams):
    d, _ = jparams
    x = _images(8, 2)
    want = jdcgan.disc_apply(d, jnp.asarray(x), JC)
    got = dcgan.disc_apply(params_from_numpy(d, CPU), _t(x), C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gen_apply_matches_jax(jparams):
    _, g = jparams
    z = _z(8, 3)
    want = jdcgan.gen_apply(g, jnp.asarray(z), JC)
    got = dcgan.gen_apply(params_from_numpy(g, CPU), _t(z), C)
    assert got.shape == (8, 28, 28, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_logits_matches_jax(target):
    logits = np.random.default_rng(4).normal(0, 8, (64, 1)).astype(np.float32)
    want = jbce_logits(jnp.asarray(logits), target)
    got = bce_logits(_t(logits), target)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

def test_d_loss_and_grads_match_jax(jparams):
    d, g = jparams
    real = _images(8, 5)
    fake = np.asarray(jdcgan.gen_apply(g, jnp.asarray(_z(8, 6)), JC))
    wl, wg = jax.value_and_grad(jd_loss_fn)(d, jnp.asarray(real),
                                            jnp.asarray(fake), JC)
    gl, gg = value_and_grad(d_loss_fn)(params_from_numpy(d, CPU), _t(real),
                                       _t(fake), C)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    _assert_trees_close(gg, wg, **TOL)


def test_g_loss_and_grads_match_jax(jparams):
    d, g = jparams
    z = _z(8, 7)
    wl, wg = jax.value_and_grad(jg_loss_fn)(g, d, jnp.asarray(z), JC)
    gl, gg = value_and_grad(g_loss_fn)(params_from_numpy(g, CPU),
                                       params_from_numpy(d, CPU), _t(z), C)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    _assert_trees_close(gg, wg, **TOL)


def test_value_and_grad_leaves_params_untouched(jparams):
    d, _ = jparams
    p = params_from_numpy(d, CPU)
    value_and_grad(d_loss_fn)(p, _t(_images(4, 8)), _t(_images(4, 9)), C)
    assert not any(l.requires_grad for l in leaves(p))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _grad_trees(tree, seed, steps):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda l: rng.normal(0, 1e-2, l.shape)
                         .astype(np.float32), tree) for _ in range(steps)]


@pytest.mark.parametrize("kw", [
    dict(beta1=0.5, beta2=0.999, eps=1e-8),                # dcgan-mnist
    dict(beta1=0.9, beta2=0.95, weight_decay=0.1, grad_clip=0.5),
])
def test_adamw_steps_match_jax(jparams, kw):
    d, _ = jparams
    jopt, opt = jadamw(**kw), adamw(**kw)
    jp, js = d, jopt.init(d)
    p = params_from_numpy(d, CPU)
    s = opt.init(p)
    for grads in _grad_trees(d, 10, 2):
        jp, js = jopt.update(grads, js, jp, jnp.asarray(2e-4))
        p, s = opt.update(params_from_numpy(grads, CPU), s, p, 2e-4)
    _assert_trees_close(p, jp, **TOL)
    _assert_trees_close(s["m"], js["m"], **TOL)
    _assert_trees_close(s["v"], js["v"], **TOL)
    assert int(s["step"]) == int(js["step"]) == 2


def test_sgd_steps_match_jax(jparams):
    d, _ = jparams
    jopt, opt = jsgd(momentum=0.9, grad_clip=1.0), sgd(momentum=0.9,
                                                      grad_clip=1.0)
    jp, js = d, jopt.init(d)
    p = params_from_numpy(d, CPU)
    s = opt.init(p)
    for grads in _grad_trees(d, 11, 2):
        jp, js = jopt.update(grads, js, jp, jnp.asarray(1e-2))
        p, s = opt.update(params_from_numpy(grads, CPU), s, p, 1e-2)
    _assert_trees_close(p, jp, **TOL)
    _assert_trees_close(s["mom"], js["mom"], **TOL)


def test_clip_by_global_norm_matches_jax(jparams):
    d, _ = jparams
    grads = _grad_trees(d, 12, 1)[0]
    jc, jn = jclip(grads, 0.05)
    tc, tn = clip_by_global_norm(params_from_numpy(grads, CPU), 0.05)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
    _assert_trees_close(tc, jc, **TOL)


# ---------------------------------------------------------------------------
# data and config copies
# ---------------------------------------------------------------------------

def test_synthetic_data_and_partition_are_identical():
    imgs, labels = synthetic_mnist(300, seed=3)
    jimgs, jlabels = jsynthetic_mnist(300, seed=3)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    parts = partition_dirichlet(imgs, labels, 5, alpha=0.5, seed=1)
    jparts = jpartition_dirichlet(jimgs, jlabels, 5, alpha=0.5, seed=1)
    assert list(parts) == list(jparts)
    for cid in parts:
        np.testing.assert_array_equal(parts[cid], jparts[cid])


def test_config_is_the_reference_config():
    over = {"shape.global_batch": 8, "fsl.num_clients": 2,
            "model.dcgan.base_filters": 8, "fed.kernel_aggregation": True}
    assert reference_dict(get_config("dcgan-mnist").override(over)) == \
        jget_config("dcgan-mnist").override(over).to_dict()


def test_registry_rejects_unported_arch():
    """Every arch of the JAX registry is ported: a name it does not know
    is refused."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("olmoe-1b-8b")
