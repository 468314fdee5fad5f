"""The port's MLA, RG-LRU and whisper encoder-decoder modules held against
the JAX package at small sizes, fp32, on the CPU.

Parameters come from the JAX inits (carried across with
``repro_torch.bridge``), inputs from numpy seeds.  MLA: the expanded
form (``mla_apply``) and the absorbed decode (``mla_decode``), also past
the end of its cache.  RG-LRU: ``causal_conv1d``, ``rglru_scan`` and
``rglru_block_apply``, and two calls chained through the conv and h
states against one call.  Encoder-decoder: ``encode``, ``_cross_attend``,
the decoder block's one-token decode and ``_cross_decode``, and a
``gqa_decode`` past the end of a full cache (whisper's decoder cache is
clipped to its 448 positions), which writes the last slot as the
reference's ``dynamic_update_slice`` clamps it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro.config import reduce_for_smoke as jreduce_for_smoke
from repro.configs.registry import get_config as jget_config
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import mla as JMLA
from repro.models import rglru as JRG
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.config import reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import rglru as RG
from repro_torch.models import transformer as T

CPU = torch.device("cpu")
TOL = dict(rtol=0, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _models(arch, seq=16):
    jm = jreduce_for_smoke(jget_config(arch, "train_4k"), seq_len=seq).model
    m = reduce_for_smoke(get_config(arch, "train_4k"), seq_len=seq).model
    return jm, m


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_setup(seed=0):
    jm, m = _models("deepseek-v2-lite-16b")
    jp = _np(jax.jit(lambda k: JMLA.mla_init(
        k, jm.d_model, jm.num_heads, jm.head_dim, jm.mla))(
        jax.random.PRNGKey(seed)))
    return jm, m, jp, params_from_numpy(jp, CPU)


@pytest.mark.parametrize("seq", [12, 1100])
def test_mla_apply_matches_jax(seq):
    """Expanded form; 1100 positions take the chunked attention.  There
    the rotary angles reach ~1,100 radians, where XLA's fp32 sin/cos and
    PyTorch's differ by a few ulps of the angle (5e-5)."""
    jm, m, jp, tp = _mla_setup()
    x = _rand((2, seq, m.d_model), 1)
    jout, (jc, jr) = jax.jit(lambda p, x: JMLA.mla_apply(
        p, x, jm.num_heads, jm.head_dim, jm.mla, None, jm.rope_theta))(
        jp, jnp.asarray(x))
    out, (c, r) = MLA.mla_apply(tp, torch.as_tensor(x), m.num_heads,
                                m.head_dim, m.mla, None, m.rope_theta)
    tol = TOL if seq < 1024 else dict(rtol=0, atol=5e-5)
    _close(out, jout, tol)
    _close(c, jc)
    _close(r, jr, tol)


@pytest.mark.parametrize("index", [5, 7, 11])
def test_mla_decode_matches_jax(index):
    """Absorbed decode against a random (B, 8, rk) / (B, 8, rh) cache; at
    index 11 the write lands in the last slot, as the reference's."""
    jm, m, jp, tp = _mla_setup(1)
    x = _rand((2, 1, m.d_model), 2)
    ckv = _rand((2, 8, m.mla.kv_lora_rank), 3)
    kr = _rand((2, 8, m.mla.rope_head_dim), 4)
    jout, (jc, jr) = jax.jit(lambda *a: JMLA.mla_decode(
        *a, jm.num_heads, jm.head_dim, jm.mla, jm.rope_theta))(
        jp, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
        jnp.asarray(index, jnp.int32))
    tc, tr = torch.as_tensor(ckv.copy()), torch.as_tensor(kr.copy())
    out, (c, r) = MLA.mla_decode(tp, torch.as_tensor(x), tc, tr, index,
                                 m.num_heads, m.head_dim, m.mla,
                                 m.rope_theta)
    assert c is tc and r is tr                # written in place
    _close(out, jout)
    _close(c, jc)
    _close(r, jr)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_setup(seed=0):
    jm, m = _models("recurrentgemma-9b")
    jp = _np(jax.jit(lambda k: JRG.rglru_block_init(k, jm.d_model,
                                                     jm.rglru))(
        jax.random.PRNGKey(seed)))
    # the gates' init is zero: give them values so they matter
    for i, k in enumerate(("a_x", "a_b", "i_x", "i_b", "conv_b")):
        jp[k] = _rand(jp[k].shape, 10 + i, 0.5)
    return jm, m, jp, params_from_numpy(jp, CPU)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    x, w, b = _rand((2, 9, 16), 1), _rand((4, 16), 2), _rand((16,), 3)
    st = _rand((2, 3, 16), 4) if with_state else None
    jy, jst = JRG.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    y, tst = RG.causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                              torch.as_tensor(b),
                              None if st is None else torch.as_tensor(st))
    _close(y, jy, dict(rtol=0, atol=1e-6))
    _close(tst, jst, dict(rtol=0, atol=0))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(with_h0):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, 16)).astype(np.float32)
    r, i = (rng.uniform(0, 1, (2, 20, 16)).astype(np.float32)
            for _ in range(2))
    a = rng.standard_normal(16).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32) if with_h0 else None
    jh, jhT = JRG.rglru_scan(*(jnp.asarray(v) for v in (x, r, i, a)),
                             None if h0 is None else jnp.asarray(h0))
    h, hT = RG.rglru_scan(*(torch.as_tensor(v) for v in (x, r, i, a)),
                          None if h0 is None else torch.as_tensor(h0))
    _close(h, jh, dict(rtol=0, atol=1e-6))
    _close(hT, jhT, dict(rtol=0, atol=1e-6))


def test_rglru_block_apply_matches_jax():
    jm, m, jp, tp = _rglru_setup()
    x = _rand((2, 12, m.d_model), 6)
    jy, (jc, jh) = jax.jit(lambda p, x: JRG.rglru_block_apply(
        p, x, jm.rglru))(jp, jnp.asarray(x))
    y, (c, h) = RG.rglru_block_apply(tp, torch.as_tensor(x), m.rglru)
    _close(y, jy)
    _close(c, jc)
    _close(h, jh)


def test_rglru_states_carried_across_two_calls_equal_one_call():
    """The conv window and h carried from positions 0..6 into 7..11: the
    conv and the scan give one call's values bit for bit, the block within
    1e-6 (its projections see other row counts)."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((2, 12, 16)).astype(np.float32))
    w, b = torch.randn(4, 16), torch.randn(16)
    full, st_full = RG.causal_conv1d(x, w, b)
    y1, st = RG.causal_conv1d(x[:, :7], w, b)
    y2, st2 = RG.causal_conv1d(x[:, 7:], w, b, st)
    assert torch.equal(torch.cat([y1, y2], 1), full)
    assert torch.equal(st2, st_full)
    r, i = torch.rand(2, 12, 16), torch.rand(2, 12, 16)
    a = torch.randn(16)
    h, hT = RG.rglru_scan(x, r, i, a)
    h1, hm = RG.rglru_scan(x[:, :7], r[:, :7], i[:, :7], a)
    h2, hT2 = RG.rglru_scan(x[:, 7:], r[:, 7:], i[:, 7:], a, hm)
    assert torch.equal(torch.cat([h1, h2], 1), h) and torch.equal(hT2, hT)

    _, m, _, tp = _rglru_setup(1)
    xb = torch.as_tensor(_rand((2, 12, m.d_model), 8))
    y, (c, hh) = RG.rglru_block_apply(tp, xb, m.rglru)
    ya, (ca, ha) = RG.rglru_block_apply(tp, xb[:, :7], m.rglru)
    yb, (cb, hb) = RG.rglru_block_apply(tp, xb[:, 7:], m.rglru, ca, ha)
    torch.testing.assert_close(torch.cat([ya, yb], 1), y, rtol=0, atol=1e-6)
    torch.testing.assert_close(cb, c, rtol=0, atol=1e-6)
    torch.testing.assert_close(hb, hh, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# whisper encoder-decoder
# ---------------------------------------------------------------------------

def _whisper(seq=12, **over):
    jcfg = jreduce_for_smoke(jget_config("whisper-base", "train_4k"),
                             seq_len=seq)
    cfg = reduce_for_smoke(get_config("whisper-base", "train_4k"),
                           seq_len=seq)
    if over:
        jcfg, cfg = jcfg.override(over), cfg.override(over)
    jp = _np(JT.lm_init(jax.random.PRNGKey(0), jcfg.model))
    return jcfg.model, cfg.model, jp, params_from_numpy(jp, CPU)


def test_encode_matches_jax():
    jm, m, jp, tp = _whisper()
    e = _rand((2, m.encdec.encoder_seq, m.d_model), 1, 0.1)
    _close(T.encode(tp, torch.as_tensor(e), m),
           jax.jit(lambda p, e: JT.encode(p, e, jm, remat="none"))(
               jp, jnp.asarray(e)))


def test_encoder_config_forces_enc_blocks():
    jm, m, _, _ = _whisper()
    enc = T._encoder_model_cfg(m)
    assert B.layer_kinds(enc) == JB.layer_kinds(JT._encoder_model_cfg(jm)) \
        == ["enc"] * m.encdec.encoder_layers
    assert B.layer_kinds(m) == ["dec"] * m.num_layers


def test_cross_attend_matches_jax():
    jm, m, jp, tp = _whisper()
    h = _rand((2, 7, m.d_model), 2)
    enc = _rand((2, m.encdec.encoder_seq, m.d_model), 3)
    blk = lambda p: jax.tree.map(lambda a: a[0], p["stack"]["b0"]["xattn"])
    jout, (jk, jv) = JB._cross_attend(blk(jp), jnp.asarray(h),
                                      jnp.asarray(enc), JB.attn_dims(jm),
                                      None)
    out, (k, v) = B._cross_attend(
        {kk: {n: t[0] for n, t in vv.items()}
         for kk, vv in tp["stack"]["b0"]["xattn"].items()},
        torch.as_tensor(h), torch.as_tensor(enc), B.attn_dims(m), None)
    _close(out, jout)
    _close(k, jk)
    _close(v, jv)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("index", [3, 9])
def test_decoder_block_decode_matches_jax(index):
    """The ``dec`` block's one-token decode: self-attention against an
    8-slot cache (index 9 past its end: the write clamps to the last
    slot), cross-attention against cached encoder K/V."""
    jm, m, jp, tp = _whisper()
    hkv, hd, se = m.num_kv_heads, m.head_dim, m.encdec.encoder_seq
    st = {"k": _rand((2, 8, hkv, hd), 4), "v": _rand((2, 8, hkv, hd), 5),
          "ck": _rand((2, se, hkv, hd), 6), "cv": _rand((2, se, hkv, hd), 7)}
    x = _rand((2, 1, m.d_model), 8)
    jx, jst = jax.jit(lambda p, x, s, i: JB.block_decode(
        "dec", p, x, s, i, jm, None))(
        _layer(jp["stack"]["b0"]), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()},
        jnp.asarray(index, jnp.int32))
    tst = {k: torch.as_tensor(v.copy()) for k, v in st.items()}
    tx, tst2 = B.block_decode("dec", _layer(tp["stack"]["b0"]),
                              torch.as_tensor(x), tst, index, m, None)
    _close(tx, jx)
    for k in st:
        _close(tst2[k], jst[k])
    xh = _rand((2, 1, m.d_model), 9)
    _close(B._cross_decode(_layer(tp["stack"]["b0"])["xattn"],
                           torch.as_tensor(xh), tst["ck"], tst["cv"],
                           B.attn_dims(m), None),
           JB._cross_decode(_layer(jp["stack"]["b0"])["xattn"],
                            jnp.asarray(xh), jnp.asarray(st["ck"]),
                            jnp.asarray(st["cv"]), JB.attn_dims(jm), None))


def test_gqa_decode_past_a_full_cache_matches_jax():
    """index >= S_cache on a full (not ring) cache: the reference's
    ``dynamic_update_slice`` writes the last slot; so does the port."""
    jm, m, jp, tp = _whisper()
    hkv, hd = m.num_kv_heads, m.head_dim
    ck, cv = _rand((2, 6, hkv, hd), 1), _rand((2, 6, hkv, hd), 2)
    x = _rand((2, 1, m.d_model), 3)
    dims, jdims = B.attn_dims(m), JB.attn_dims(jm)
    for index in (6, 9):
        jout, (jk, jv) = JL.gqa_decode(
            _layer(jp["stack"]["b0"])["attn"], jnp.asarray(x),
            jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(index, jnp.int32),
            jdims)
        tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
        out, (k, v) = L.gqa_decode(_layer(tp["stack"]["b0"])["attn"],
                                   torch.as_tensor(x), tk, tv, index, dims)
        _close(out, jout)
        _close(k, jk)
        _close(v, jv)
        assert not torch.equal(k[:, -1], torch.as_tensor(ck[:, -1]))


def test_whisper_decode_past_max_target_positions_matches_jax():
    """max_target_positions cut to 8: prefill 6 tokens into a cache of
    min(16, 8) slots, then decode to position 15, past the cache and the
    sinusoidal table's end (both clamp), in both packages alike."""
    jm, m, jp, tp = _whisper(seq=16, **{"model.encdec.max_target_positions":
                                        8})
    toks = np.random.default_rng(2).integers(0, m.vocab_size, (2, 16)
                                             ).astype(np.int32)
    e = _rand((2, m.encdec.encoder_seq, m.d_model), 4, 0.1)
    jlg, jst, _ = jax.jit(lambda p, b: JT.lm_prefill(
        p, b, jm, cache_len=16, cache_dtype=jnp.float32))(
        jp, {"tokens": jnp.asarray(toks[:, :6]),
             "enc_embeds": jnp.asarray(e)})
    jdecode = jax.jit(lambda p, tk, st, t: JT.lm_decode_step(p, tk, st, t,
                                                              jm))
    lg, st, idx = T.lm_prefill(tp, {"tokens": torch.as_tensor(toks[:, :6]),
                                    "enc_embeds": torch.as_tensor(e)}, m,
                               cache_len=16, cache_dtype=torch.float32)
    assert idx == 6 and st["stack"]["b0"]["k"].shape[2] == 8
    _close(lg, jlg, dict(rtol=0, atol=1e-4))
    for t in range(6, 16):
        jlg, jst = jdecode(jp, jnp.asarray(toks[:, t]), jst,
                           jnp.asarray(t, jnp.int32))
        lg, st = T.lm_decode_step(tp, torch.as_tensor(toks[:, t]), st, t, m)
        _close(lg, jlg, dict(rtol=0, atol=1e-4))
    for a, b in zip(jax.tree.leaves(jst), jax.tree.leaves(st)):
        _close(b, a, dict(rtol=0, atol=1e-4))
