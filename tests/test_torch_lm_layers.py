"""The port's LM layers and RWKV-6 modules held against the JAX package.

Same inputs on both sides: numpy arrays from seeded generators, and
parameters from the JAX ``*_init`` functions carried across with
``repro_torch.bridge`` (the zero-initialised mixing and decay leaves are
filled with random values, so that every term is exercised).  Everything
runs in fp32 on the CPU; each function must match its JAX counterpart to
1e-5 absolute (fp32 sums taken in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro.config import RWKVConfig as JRWKVConfig
from repro.models import layers as JL
from repro.models import rwkv6 as JRW
from repro_torch.bridge import params_from_numpy
from repro_torch.config import RWKVConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as RW

TOL = dict(rtol=0, atol=1e-5)
KEY = jax.random.PRNGKey(3)


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def _bridge(jtree):
    return jax.tree.map(np.asarray, jtree), params_from_numpy(
        jax.tree.map(np.asarray, jtree), "cpu")


def _randomise(tree, seed, scale=0.3):
    """Every leaf of a numpy tree replaced by a random one of its shape."""
    leaves, treedef = jax.tree.flatten(tree)
    return jax.tree.unflatten(treedef, [
        _np(l.shape, seed + i, scale) for i, l in enumerate(leaves)])


# ---------------------------------------------------------------------------
# dense, norms, embedding, positions, RoPE, MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
def test_dense_apply(bias):
    jp = jax.tree.map(np.asarray, JL.dense_init(KEY, 24, 40, bias=bias))
    if bias:
        jp["b"] = _np((40,), 1)
    x = _np((2, 5, 24), 2)
    _close(L.dense_apply(params_from_numpy(jp, "cpu"), torch.tensor(x)),
           JL.dense_apply(jp, jnp.asarray(x)))


def test_norms_and_embedding():
    x = _np((2, 7, 32), 3, 2.0)
    p = {"scale": _np((32,), 4), "bias": _np((32,), 5)}
    tp = params_from_numpy(p, "cpu")
    _close(L.rmsnorm_apply({"scale": tp["scale"]}, torch.tensor(x), 1e-6),
           JL.rmsnorm_apply({"scale": p["scale"]}, jnp.asarray(x), 1e-6))
    _close(L.layernorm_apply(tp, torch.tensor(x)),
           JL.layernorm_apply(p, jnp.asarray(x)))
    table = _np((50, 32), 6)
    ids = np.random.default_rng(7).integers(0, 50, (2, 7)).astype(np.int32)
    _close(L.embedding_apply({"table": torch.tensor(table)},
                             torch.tensor(ids)),
           JL.embedding_apply({"table": table}, jnp.asarray(ids)))
    _close(L.unembed_apply({"table": torch.tensor(table)}, torch.tensor(x)),
           JL.unembed_apply({"table": table}, jnp.asarray(x)))
    _close(L.sinusoidal_positions(9, 16), JL.sinusoidal_positions(9, 16))


@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope(batched_positions):
    x = _np((2, 6, 3, 16), 8)
    pos = np.arange(6, dtype=np.int32) + 3
    if batched_positions:
        pos = np.stack([pos, pos * 2])
    _close(L.rope_freqs(16, 1e6), JL.rope_freqs(16, 1e6))
    _close(L.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    assert L.apply_rope(torch.tensor(x), torch.tensor(pos), 0.0) is not None


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    jp, tp = _bridge(JL.mlp_init(KEY, 32, 64, act))
    if act != "silu":
        jp = _randomise(jp, 9, 0.1)
        tp = params_from_numpy(jp, "cpu")
    x = _np((2, 5, 32), 10)
    _close(L.mlp_apply(tp, torch.tensor(x), act),
           JL.mlp_apply(jp, jnp.asarray(x), act))


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------

def _qkv(b, lq, lk, h, hkv, d, seed):
    return (_np((b, lq, h, d), seed), _np((b, lk, hkv, d), seed + 1),
            _np((b, lk, hkv, d), seed + 2))


@pytest.mark.parametrize("window,valid", [(0, False), (5, False),
                                          (0, True), (7, True)])
def test_attention_full(window, valid):
    q, k, v = _qkv(2, 12, 12, 4, 2, 16, 11)
    pos = np.arange(12, dtype=np.int32)
    kv_valid = (np.random.default_rng(12).random((2, 12)) < 0.7) if valid \
        else None
    kv_valid_t = None if kv_valid is None else torch.tensor(kv_valid)
    got = L.attention_full(*(torch.tensor(a) for a in (q, k, v)),
                           torch.tensor(pos), torch.tensor(pos), window,
                           kv_valid_t)
    want = JL.attention_full(*(jnp.asarray(a) for a in (q, k, v)),
                             jnp.asarray(pos), jnp.asarray(pos), window,
                             None if kv_valid is None
                             else jnp.asarray(kv_valid))
    _close(got, want)


@pytest.mark.parametrize("lk,kv_chunk,window,valid", [
    (40, 16, 0, False),     # Lk not a chunk multiple: padded chunk
    (48, 16, 9, False),     # three full chunks, sliding window
    (40, 8, 0, True),       # explicit valid mask, padded
])
def test_attention_chunked(lk, kv_chunk, window, valid):
    q, k, v = _qkv(2, lk, lk, 4, 1, 16, 13)
    pos = np.arange(lk, dtype=np.int32)
    kv_valid = None
    if valid:
        kv_valid = np.random.default_rng(14).random((2, lk)) < 0.8
        kv_valid[:, 0] = True
    args_t = [torch.tensor(a) for a in (q, k, v, pos, pos)]
    args_j = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    got = L.attention_chunked(*args_t, window,
                              None if kv_valid is None
                              else torch.tensor(kv_valid), kv_chunk)
    want = JL.attention_chunked(*args_j, window,
                                None if kv_valid is None
                                else jnp.asarray(kv_valid), kv_chunk)
    _close(got, want)
    # the dispatch takes the chunked path beyond kv_chunk, the full one below
    _close(L.attention(*args_t, window, kv_chunk=kv_chunk),
           JL.attention(*args_j, window, kv_chunk=kv_chunk))
    _close(L.attention(*args_t, window, kv_chunk=kv_chunk, force_full=True),
           JL.attention(*args_j, window, kv_chunk=kv_chunk, force_full=True))


DIMS = [dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
             qk_norm=True, rope_theta=1e6),
        dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
             qkv_bias=True, window=5)]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dims", DIMS, ids=["gqa_qknorm", "bias_window"])
def test_gqa_apply(dims, use_kernel):
    jd, td = JL.AttnDims(**dims), L.AttnDims(**dims)
    jp = _randomise(jax.tree.map(np.asarray, JL.gqa_init(KEY, jd)), 15, 0.2)
    tp = params_from_numpy(jp, "cpu")
    x = _np((2, 10, 64), 16)
    got, (gk, gv) = L.gqa_apply(tp, torch.tensor(x), td,
                                use_kernel=use_kernel)
    want, (wk, wv) = JL.gqa_apply(jp, jnp.asarray(x), jd,
                                  use_kernel=use_kernel)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("dims", DIMS, ids=["full_cache", "ring_cache"])
def test_gqa_decode(dims):
    jd, td = JL.AttnDims(**dims), L.AttnDims(**dims)
    jp = _randomise(jax.tree.map(np.asarray, JL.gqa_init(KEY, jd)), 17, 0.2)
    tp = params_from_numpy(jp, "cpu")
    s_cache = dims.get("window") or 12
    ck = _np((2, s_cache, dims["num_kv_heads"], 16), 18)
    cv = _np((2, s_cache, dims["num_kv_heads"], 16), 19)
    jck, jcv = jnp.asarray(ck), jnp.asarray(cv)
    tck, tcv = torch.tensor(ck), torch.tensor(cv)
    for step, index in enumerate((3, 4, 9, 11)):   # the ring wraps at 5
        x = _np((2, 1, 64), 20 + step)
        want, (jck, jcv) = JL.gqa_decode(jp, jnp.asarray(x), jck, jcv,
                                         jnp.asarray(index, jnp.int32), jd)
        got, (tck, tcv) = L.gqa_decode(tp, torch.tensor(x), tck, tcv, index,
                                       td)
        _close(got, want)
        _close(tck, jck)
        _close(tcv, jcv)


# ---------------------------------------------------------------------------
# RWKV-6 time mix and channel mix
# ---------------------------------------------------------------------------

RWKV = dict(head_dim=16, decay_lora=8, token_shift_lora=4, gate_lora=8)


def _timemix_params(seed):
    jp = jax.tree.map(np.asarray, JRW.timemix_init(
        KEY, 64, JRWKVConfig(**RWKV)))
    return _randomise(jp, seed, 0.2)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("carry", [False, True])
def test_timemix_apply(carry, use_kernel):
    jp = _timemix_params(21)
    tp = params_from_numpy(jp, "cpu")
    x = _np((2, 9, 64), 22)
    prev = _np((2, 64), 23) if carry else None
    s0 = _np((2, 4, 16, 16), 24, 0.1) if carry else None
    want, (wx, ws) = JRW.timemix_apply(
        jp, jnp.asarray(x), JRWKVConfig(**RWKV),
        x_prev_last=None if prev is None else jnp.asarray(prev),
        state0=None if s0 is None else jnp.asarray(s0),
        use_kernel=use_kernel)
    got, (gx, gs) = RW.timemix_apply(
        tp, torch.tensor(x), RWKVConfig(**RWKV),
        x_prev_last=None if prev is None else torch.tensor(prev),
        state0=None if s0 is None else torch.tensor(s0),
        use_kernel=use_kernel)
    _close(got, want)
    _close(gx, wx)
    _close(gs, ws)


@pytest.mark.parametrize("carry", [False, True])
def test_channelmix_apply(carry):
    jp = _randomise(jax.tree.map(np.asarray, JRW.channelmix_init(
        KEY, 64, 128)), 25, 0.2)
    tp = params_from_numpy(jp, "cpu")
    x = _np((2, 7, 64), 26)
    prev = _np((2, 64), 27) if carry else None
    want, wx = JRW.channelmix_apply(
        jp, jnp.asarray(x), None if prev is None else jnp.asarray(prev))
    got, gx = RW.channelmix_apply(
        tp, torch.tensor(x), None if prev is None else torch.tensor(prev))
    _close(got, want)
    _close(gx, wx)


def test_ddlerp_and_scan():
    jp = _timemix_params(28)
    tp = params_from_numpy(jp, "cpu")
    x, xp = _np((2, 5, 64), 29), _np((2, 5, 64), 30)
    want = JRW.ddlerp(jp, jnp.asarray(x), jnp.asarray(xp))
    got = RW.ddlerp(tp, torch.tensor(x), torch.tensor(xp))
    for n in RW.MIX_NAMES:
        _close(got[n], want[n])
    r, k, v = (_np((2, 11, 4, 16), 31 + i) for i in range(3))
    w = np.exp(-np.exp(_np((2, 11, 4, 16), 34, 0.5)))
    u = _np((4, 16), 35, 0.1)
    wo, wsT = JRW.wkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)), 16)
    go, gsT = RW.wkv6_scan(*(torch.tensor(a) for a in (r, k, v, w, u)), 16)
    _close(go, wo, dict(rtol=0, atol=1e-4))
    _close(gsT, wsT, dict(rtol=0, atol=1e-4))


def test_attn_dims_is_a_frozen_copy():
    assert [f.name for f in dataclasses.fields(L.AttnDims)] == \
        [f.name for f in dataclasses.fields(JL.AttnDims)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        L.AttnDims(8, 2, 2, 4).window = 3
