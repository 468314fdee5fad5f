"""The port's MoE layer (``repro_torch.models.moe``) held against the JAX
package's ``repro.models.moe`` at small sizes, fp32, on the CPU.

Both packages get the JAX ``moe_init`` parameters (carried across with
``repro_torch.bridge``) and the same numpy inputs.  ``moe_apply`` must
match JAX's to 1e-5 (its output) and 1e-6 (the aux loss), with and
without capacity drops and over several dispatch groups; among tied
router probabilities the port must pick the experts ``lax.top_k`` picks
(the lower index first).  The last six tests are twins of
``tests/test_moe.py``'s, run on the port.  The combine adds each token's
k expert outputs in a fixed order (no float atomics), so two forwards on
the card are equal bit for bit: ``tests/test_torch_lm_gpu.py`` holds that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro.config import MoEConfig as JMoEConfig
from repro.models import moe as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.config import MoEConfig
from repro_torch.models import moe as M
from repro_torch.models.layers import mlp_apply

CPU = torch.device("cpu")
Y_TOL = dict(rtol=0, atol=1e-5)
AUX_TOL = dict(rtol=0, atol=1e-6)


def _setup(d, x_shape, seed=0, **cfg):
    jcfg, tcfg = JMoEConfig(**cfg), MoEConfig(**cfg)
    # under jax.jit: eager, the init's random draws compile one by one
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda k: JM.moe_init(k, d, jcfg))(jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).standard_normal(x_shape).astype(
        np.float32)
    return jcfg, tcfg, jp, params_from_numpy(jp, CPU), x


_JITTED = {}


def _jmoe(jp, x, jcfg):
    """The JAX ``moe_apply`` under ``jax.jit``, one compile a config
    (eager dispatch compiles every primitive of the vmapped dispatch
    anew)."""
    key = repr(jcfg)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda p, x: JM.moe_apply(p, x, jcfg))
    return _JITTED[key](jp, jnp.asarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# (d, x shape, MoEConfig fields): shared experts, capacity drops, several
# dispatch groups at olmoe's (64, top-8) and deepseek's (64 + 2 shared,
# top-6) routing
CASES = {
    "shared": (32, (2, 10, 32), dict(num_experts=8, num_shared_experts=1,
                                     top_k=2, d_ff_expert=16)),
    "drops": (16, (1, 32, 16), dict(num_experts=4, top_k=2, d_ff_expert=8,
                                    capacity_factor=0.3)),
    "olmoe_routing": (32, (2, 64, 32), dict(num_experts=64, top_k=8,
                                            d_ff_expert=16,
                                            router_aux_coef=0.01)),
    "deepseek_routing": (32, (2, 48, 32), dict(
        num_experts=64, num_shared_experts=2, top_k=6, d_ff_expert=16,
        router_aux_coef=0.003, capacity_factor=0.5)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_jax(case):
    d, shape, fields = CASES[case]
    jcfg, tcfg, jp, tp, x = _setup(d, shape, **fields)
    jy, jaux = _jmoe(jp, x, jcfg)
    y, aux = M.moe_apply(tp, torch.as_tensor(x), tcfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    _close(y, jy, Y_TOL)
    _close(aux, jaux, AUX_TOL)


def test_capacity_drops_happen_and_match_jax():
    """At capacity factor 0.3 some token-slots overflow: their tokens get
    less than their full combine weight, in both packages alike."""
    d, shape, fields = CASES["drops"]
    jcfg, tcfg, jp, tp, x = _setup(d, shape, **fields)
    xt = torch.as_tensor(x).reshape(1, -1, d)
    probs, _ = M.router_probs(tp, xt, tcfg)
    _, top_i = M.top_k(probs, tcfg.top_k)
    counts = torch.bincount(top_i.reshape(-1), minlength=tcfg.num_experts)
    t = xt.shape[1]
    cap = int(max(2, ((t * 2 * 0.3) / 4) // 1 + 1))
    assert int(counts.max()) > cap            # some expert overflows
    jy, _ = _jmoe(jp, x, jcfg)
    y, _ = M.moe_apply(tp, torch.as_tensor(x), tcfg)
    _close(y, jy, Y_TOL)


def test_ties_pick_the_lower_index_as_lax_top_k():
    """A zero router gives every expert probability 1/E: the picks are
    experts 0..k-1 for every token, as ``lax.top_k``'s; and on logits
    rounded to a coarse grid (ties among 64 experts everywhere) the
    port's top k equal ``lax.top_k``'s, values and indices."""
    d, shape, fields = CASES["olmoe_routing"]
    jcfg, tcfg, jp, tp, x = _setup(d, shape, **fields)
    jp["router"]["w"] = np.zeros_like(jp["router"]["w"])
    tp["router"]["w"] = torch.zeros_like(tp["router"]["w"])
    xt = torch.as_tensor(x).reshape(1, -1, d)
    probs, _ = M.router_probs(tp, xt, tcfg)
    vals, idx = M.top_k(probs, tcfg.top_k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), tcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx == torch.arange(tcfg.top_k)).all()
    jy, jaux = _jmoe(jp, x, jcfg)
    y, aux = M.moe_apply(tp, torch.as_tensor(x), tcfg)
    _close(y, jy, Y_TOL)
    _close(aux, jaux, AUX_TOL)

    logits = np.round(np.random.default_rng(3).standard_normal(
        (256, 64)) * 2) / 2
    probs = torch.softmax(torch.as_tensor(logits, dtype=torch.float32), -1)
    vals, idx = M.top_k(probs, 8)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("t,k", [(8, 2), (64, 8), (4096, 8), (4096, 6),
                                 (4, 8), (1000, 2)])
def test_dispatch_groups_are_the_reference_groups(t, k):
    assert M._dispatch_groups(t, k) == JM._dispatch_groups(t, k)


def test_load_balance_loss_matches_jax_with_leading_axes():
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(8), (3, 20)).astype(np.float32)
    idx = rng.integers(0, 8, (3, 20, 2))
    got = M.load_balance_loss(torch.as_tensor(probs), torch.as_tensor(idx), 8)
    for g in range(3):
        _close(got[g], JM.load_balance_loss(jnp.asarray(probs[g]),
                                            jnp.asarray(idx[g]), 8), AUX_TOL)


# ---------------------------------------------------------------------------
# twins of tests/test_moe.py, on the port
# ---------------------------------------------------------------------------

def _port_init(d, **fields):
    return M.moe_init(torch.Generator().manual_seed(0), d,
                      MoEConfig(**fields)), MoEConfig(**fields)


def test_single_expert_topk1_equals_dense_mlp():
    """E=1, k=1 routing reduces exactly to one SwiGLU expert on all
    tokens."""
    p, cfg = _port_init(16, num_experts=1, top_k=1, d_ff_expert=32,
                        router_aux_coef=0.0)
    x = torch.randn((2, 6, 16), generator=torch.Generator().manual_seed(1))
    y, aux = M.moe_apply(p, x, cfg)
    dense_p = {"gate": {"w": p["experts"]["gate"][0]},
               "up": {"w": p["experts"]["up"][0]},
               "down": {"w": p["experts"]["down"][0]}}
    torch.testing.assert_close(y, mlp_apply(dense_p, x, "silu"), rtol=0,
                               atol=1e-5)


def test_moe_finite_and_shape():
    p, cfg = _port_init(32, num_experts=8, num_shared_experts=1, top_k=2,
                        d_ff_expert=16)
    x = torch.randn((2, 10, 32), generator=torch.Generator().manual_seed(0))
    y, aux = M.moe_apply(p, x, cfg)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))


def test_load_balance_loss_uniform_is_one():
    """Perfectly uniform routing gives loss == E * E*(1/E)*(1/E) == 1."""
    e, t = 8, 64
    probs = torch.full((t, e), 1.0 / e)
    idx = (torch.arange(t) % e)[:, None]
    assert float(M.load_balance_loss(probs, idx, e)) == pytest.approx(
        1.0, rel=1e-5)


def test_load_balance_loss_penalizes_collapse():
    e, t = 8, 64
    probs = torch.zeros((t, e))
    probs[:, 0] = 1.0
    idx = torch.zeros((t, 1), dtype=torch.int64)
    assert float(M.load_balance_loss(probs, idx, e)) > 4 * 1.0


def test_capacity_drop_keeps_output_finite():
    """A tiny capacity factor forces drops; outputs stay finite."""
    p, cfg = _port_init(16, num_experts=4, top_k=2, d_ff_expert=8,
                        capacity_factor=0.3)
    x = torch.randn((1, 32, 16), generator=torch.Generator().manual_seed(0))
    y, aux = M.moe_apply(p, x, cfg)
    assert bool(torch.isfinite(y).all())


def test_router_gradients_flow():
    p, cfg = _port_init(16, num_experts=4, top_k=2, d_ff_expert=8)
    x = torch.randn((1, 8, 16), generator=torch.Generator().manual_seed(0))
    w = p["router"]["w"].clone().requires_grad_(True)
    y, aux = M.moe_apply(dict(p, router={"w": w}), x, cfg)
    (torch.sum(y ** 2) + aux).backward()
    assert float(w.grad.abs().max()) > 0, "router got no gradient"
