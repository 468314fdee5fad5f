"""The port's flash_attention and wkv6 ops held against the JAX package,
and their CUDA kernels held against the plain versions.

On the CPU the port's ops take their plain versions (``ref.py``); they must
match the JAX ops with the Pallas kernels run in interpret mode, on the
cases of ``tests/test_kernels.py``: flash attention to 2e-5 and the WKV-6
recurrence to 1e-4, the tolerances the reference's own kernel tests use
(fp32 sums in another order; the recurrence compounds them over time).
The CUDA kernels run only on a GPU: those tests carry the ``gpu`` marker
and skip here.  The bf16 flash kernel's arithmetic (tensor-core products,
exp2 online softmax, P split into a bf16 high part and residual) is
emulated here with PyTorch and held to the card's bf16 pin.

    python tests/test_torch_lm_kernels.py

prints how many outputs the emulation puts outside that pin with the
split and with one bf16 rounding of P instead.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import cuda, one_thread  # noqa: F401

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.wkv6.ops import wkv6 as jwkv6
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS,
                                                        TC_BLOCK_K,
                                                        flash_attention_kernel,
                                                        on_tensor_cores,
                                                        smem_bytes,
                                                        tc_block_k, tma_ok)
from repro_torch.kernels.flash_attention.ops import (_tma_ready,
                                                     flash_attention,
                                                     pad_head_dim,
                                                     padded_head_dim)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.wkv6.kernel import wkv6_kernel
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_ref


# the cases of tests/test_kernels.py
FLASH_CASES = [
    # (b, sq, sk, h, hkv, d, causal, window)
    (2, 128, 128, 4, 4, 64, True, 0),
    (1, 256, 256, 4, 2, 64, True, 0),      # GQA 2:1
    (2, 200, 200, 4, 1, 128, True, 0),     # MQA + unaligned seq
    (1, 256, 256, 2, 2, 64, True, 64),     # sliding window
    (1, 384, 384, 8, 8, 32, True, 0),      # small head_dim
    (1, 1, 384, 4, 2, 64, False, 0),       # single-query decode pattern
    (3, 64, 64, 2, 2, 64, True, 0),        # seq < block
]
WKV_CASES = [
    # (b, t, h, n, block_t of the TPU op)
    (2, 64, 2, 32, 16),
    (1, 100, 4, 64, 64),    # unaligned t
    (2, 17, 1, 16, 8),
    (1, 128, 2, 8, 32),
]


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _flash_inputs(b, sq, sk, h, hkv, d, seed):
    return (_np((b, sq, h, d), seed), _np((b, sk, hkv, d), seed + 1),
            _np((b, sk, hkv, d), seed + 2))


def _wkv_inputs(b, t, h, n, seed):
    r, k, v = (_np((b, t, h, n), seed + i) for i in range(3))
    w = np.exp(-np.exp(_np((b, t, h, n), seed + 3, 0.5)))
    u = _np((h, n), seed + 4, 0.1)
    s0 = _np((b, h, n, n), seed + 5, 0.1)
    return r, k, v, w, u, s0


# ---------------------------------------------------------------------------
# flash attention: the op vs JAX, the plain version's masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_jax(case):
    b, sq, sk, h, hkv, d, causal, win = case
    q, k, v = _flash_inputs(b, sq, sk, h, hkv, d, seed=sum(case))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=win, interpret=True)
    before = flash_attention_kernel.launches
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=causal, window=win)
    assert flash_attention_kernel.launches == before   # CPU: plain version
    assert got.shape == (b, sq, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_flash_attention_bf16_matches_jax():
    q, k, v = _flash_inputs(1, 128, 128, 2, 2, 64, seed=40)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jflash(jq, jk, jv, interpret=True)
    got = flash_attention(*(torch.tensor(np.asarray(a.astype(jnp.float32))
                                         ).to(torch.bfloat16)
                            for a in (jq, jk, jv)))
    assert got.dtype == torch.bfloat16
    # both compute in fp32 from the same bf16 inputs and round the output
    # once: at most one bf16 ulp apart (|out| < 4)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=2 ** -6)


def test_flash_plain_version_masks():
    """q_offset shifts the causal diagonal; keys past seq_k_valid are
    masked; a row with no unmasked key averages v over all keys."""
    b, h, hkv, sq, sk, d = 1, 4, 2, 8, 24, 16
    q = torch.tensor(_np((b, h, sq, d), 41))
    k = torch.tensor(_np((b, hkv, sk, d), 42))
    v = torch.tensor(_np((b, hkv, sk, d), 43))
    # Sq < Sk with q_offset: the last rows of a longer sequence
    full_q = torch.cat([torch.zeros((b, h, sk - sq, d)), q], dim=2)
    want = attention_ref(full_q, k, v)[:, :, sk - sq:]
    torch.testing.assert_close(attention_ref(q, k, v, q_offset=sk - sq),
                               want)
    # keys past 10 masked, window 4, q_offset 14: rows 14..21 see nothing
    out = attention_ref(q, k, v, window=4, q_offset=14, seq_k_valid=10)
    mean_v = torch.repeat_interleave(v, 2, dim=1).mean(dim=2, keepdim=True)
    torch.testing.assert_close(out, mean_v.expand_as(out))


# the bf16 kernel's pin against the plain version: both round an fp32
# result once, so they may differ by one bf16 ulp
BF16_PIN = dict(rtol=2 ** -7, atol=1e-5)
# the reference's seven cases, Sq < Sk with q_offset, and rows that a
# window and a valid length leave with no key:
# (b, sq, sk, h, hkv, d, causal, window, q_offset, seq_k_valid)
TC_CASES = ([c + (0, None) for c in FLASH_CASES]
            + [(1, 100, 300, 8, 2, 128, True, 0, 200, None),
               (2, 70, 150, 4, 2, 64, True, 16, 100, 100)])
# head_dim 256 (64-key blocks): recurrentgemma-9b's GQA 16/1 with a window,
# q_offset with Sq < Sk, rows that a window and a valid length leave with
# no key, and Sq / Sk that are no multiple of the 128-row q tile or the
# 64-key block, causal and not
TC_CASES_256 = [(1, 130, 130, 16, 1, 256, True, 64, 0, None),
                (1, 70, 200, 4, 2, 256, True, 0, 130, None),
                (2, 70, 150, 4, 2, 256, True, 16, 100, 100),
                (2, 130, 190, 4, 2, 256, False, 0, 0, None)]


def _tc_emulation(q, k, v, *, causal, window, q_offset=0, seq_k_valid=None,
                  split=True, block_k=128):
    """The bf16 tensor-core kernel's numerics in PyTorch, on (B, H, S, D)
    bf16 tensors: bf16 products summed in fp32 (wgmma), logits prescaled
    by scale * log2(e), masked to the finite -1e30, an online softmax over
    kv blocks of ``block_k`` with exp2, P rounded to bf16 (``split``: plus
    its bf16 residual, a second product into the same fp32 accumulator),
    and the output o = acc * (1 / max(l, 1e-30)) rounded to bf16."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    groups = h // k.shape[1]
    kf = torch.repeat_interleave(k, groups, dim=1).float()
    vf = torch.repeat_interleave(v, groups, dim=1).float()
    x = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (
        d ** -0.5 * math.log2(math.e))
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    ok = kp < (sk if seq_k_valid is None else seq_k_valid)
    if causal:
        ok = ok & (qp >= kp)
        if window > 0:
            ok = ok & (qp - kp < window)
    x = torch.where(ok, x, torch.tensor(-1e30))
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, block_k):
        xb = x[..., k0:k0 + block_k]
        mn = torch.maximum(m, xb.amax(-1, keepdim=True))
        p = torch.exp2(xb - mn)
        corr = torch.exp2(m - mn)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        vb = vf[..., k0:k0 + block_k, :]
        acc = acc * corr + hi @ vb
        if split:
            acc = acc + (p - hi).to(torch.bfloat16).float() @ vb
        m = mn
    return (acc * (1.0 / torch.clamp(l, min=1e-30))).to(torch.bfloat16)


def _tc_case_inputs(case):
    b, sq, sk, h, hkv, d = case[:6]
    return tuple(torch.tensor(a).to(torch.bfloat16).transpose(1, 2)
                 for a in _flash_inputs(b, sq, sk, h, hkv, d,
                                        seed=sum(case[:6])))


@pytest.mark.parametrize("case", TC_CASES + TC_CASES_256)
def test_flash_tensor_core_numerics_hold_the_bf16_pin(case):
    """The split of P keeps the redesigned kernel within one bf16 ulp of
    the plain version, at the unchanged pin, with the kv block the kernel
    takes at the case's head_dim (64 keys at D = 256)."""
    causal, window, q_offset, skv = case[6:]
    q, k, v = _tc_case_inputs(case)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              seq_k_valid=skv)
    got = _tc_emulation(q, k, v, block_k=TC_BLOCK_K[case[5]], **kw)
    want = attention_ref(q, k, v, **kw)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_PIN)


def test_flash_route_sends_bf16_to_the_tensor_cores_at_every_head_dim():
    """The route depends on dtype alone: bf16 takes the tensor-core
    kernel (and so TMA's operand rules), fp32 the CUDA-core kernel; every
    instantiated head_dim, 256 included, has a tensor-core kv block, the
    one the CPU emulation takes (``TC_BLOCK_K``, a multiple of 16)."""
    assert on_tensor_cores(torch.bfloat16)
    assert not on_tensor_cores(torch.float32)
    assert HEAD_DIMS == (32, 64, 128, 256)
    assert set(TC_BLOCK_K) == set(HEAD_DIMS)
    assert all(bk % 16 == 0 for bk in TC_BLOCK_K.values())


# head_dims the kernel is not built for, each padded to the next of
# HEAD_DIMS by the op: (b, s, h, hkv, d, window); window 0 is causal only
PAD_CASES = [(1, 128, 4, 2, d, win) for d in (16, 48, 80, 96)
             for win in (0, 48)] + [(1, 256, 2, 1, 256, 0),
                                    (1, 256, 2, 1, 256, 96)]


@pytest.mark.parametrize("case", PAD_CASES)
def test_flash_padded_head_dims_match_jax(case):
    """The GPU op's padding, on the CPU: q, k, v zero-padded along D with
    the original D's scale, through the plain version, sliced back to D,
    equal the JAX op (which takes any D) at the fp32 cases' tolerance."""
    b, s, h, hkv, d, win = case
    q, k, v = _flash_inputs(b, s, s, h, hkv, d, seed=sum(case))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, window=win, interpret=True)
    qp, kp, vp, scale, d0 = pad_head_dim(*(torch.tensor(a) for a in (q, k,
                                                                        v)))
    assert d0 == d and qp.shape[-1] == padded_head_dim(d) in HEAD_DIMS
    assert scale == d ** -0.5
    got = attention_ref(*(t.transpose(1, 2) for t in (qp, kp, vp)),
                        causal=True, window=win, scale=scale
                        ).transpose(1, 2)[..., :d]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_every_head_dim_up_to_256_pads_to_an_instantiated_size():
    for d in range(1, 257):
        size = padded_head_dim(d)
        assert size in HEAD_DIMS and size >= d
        assert all(x < d for x in HEAD_DIMS if x < size)   # the next one
    q = torch.ones(1, 2, 1, 8)
    qp = pad_head_dim(q, q, q)[0]
    assert qp.shape == (1, 2, 1, 32) and float(qp[..., 8:].abs().sum()) == 0
    q = torch.ones(1, 2, 1, 32)
    assert pad_head_dim(q, q, q)[0] is q                   # no copy
    with pytest.raises(ValueError, match="at most 256"):
        padded_head_dim(257)


def test_tma_ok_flags_the_views_the_gpu_refusal_test_uses():
    """The two bf16 views the kernel refuses on the card (see
    test_flash_kernel_refuses_what_tma_cannot_take_on_gpu) fail the
    predicate, and the op's copy of each passes it with equal values."""
    fresh = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    assert tma_ok(fresh.transpose(1, 2))
    views = {
        "head stride of 136 bytes": torch.randn(
            1, 16, 2, 68).to(torch.bfloat16)[..., :64],
        "address off by 2 bytes": torch.randn(
            1 * 16 * 2 * 64 + 1).to(torch.bfloat16)[1:].view(1, 16, 2, 64)}
    for name, q in views.items():
        assert not tma_ok(q.transpose(1, 2)), name
        ready = _tma_ready(q)
        assert tma_ok(ready), name
        assert torch.equal(ready, q.transpose(1, 2)), name
    assert _tma_ready(fresh).data_ptr() == fresh.data_ptr()    # no copy


def test_flash_ops_are_forward_only():
    q, k, v = (torch.tensor(a) for a in _flash_inputs(1, 8, 8, 2, 2, 16, 44))
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q.requires_grad_(True), k, v)


# ---------------------------------------------------------------------------
# wkv6: the op vs JAX, state chaining
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_matches_jax(case):
    b, t, h, n, bt = case
    r, k, v, w, u, s0 = _wkv_inputs(b, t, h, n, seed=sum(case))
    want_o, want_s = jwkv6(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)),
                           block_t=bt, interpret=True)
    before = wkv6_kernel.launches
    got_o, got_s = wkv6(*(torch.tensor(a) for a in (r, k, v, w, u, s0)))
    assert wkv6_kernel.launches == before
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-4)


def test_wkv6_state_chaining_equals_single_pass():
    r, k, v, w, u, _ = (torch.tensor(a) for a in _wkv_inputs(1, 64, 2, 16,
                                                               50))
    full, sT = wkv6(r, k, v, w, u)
    h1, s1 = wkv6(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u)
    h2, s2 = wkv6(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u, state0=s1)
    torch.testing.assert_close(torch.cat([h1, h2], 1), full, rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(s2, sT, rtol=0, atol=1e-4)
    jo, js = jwkv6(*(jnp.asarray(a.numpy()) for a in (r, k, v, w, u)),
                   block_t=16, interpret=True)
    np.testing.assert_allclose(full.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-4)


def wkv6_split(n):
    """(G, C) of the CUDA kernel for head size n (``csrc/wkv6.cu``'s
    ``dispatch``): G row slices of the state, C columns a thread."""
    return {64: (16, 4), 32: (8, 2)}.get(n, (8, 1))


def _wkv6_emulation(r, k, v, w, u, state0=None):
    """The CUDA kernel's arithmetic in PyTorch, on (B, T, H, N) fp32
    tensors: each column of S is split over G threads, thread g holding the
    rows 4 (g + G m) + e (float4 groups, when N / G is a multiple of 4;
    else rows g + G m), m = 0, 1, ... in order; a thread sums r t over its
    rows in that order, and the G partial sums of a column are added
    pairwise in slice order, ((p0 + p1) + (p2 + p3)) + ..., as the kernel
    adds them at the end of a chunk.  How many columns a thread holds
    changes no sum."""
    b, t, h, n = r.shape
    g, _ = wkv6_split(n)
    rows = n // g
    quad = rows % 4 == 0
    # ids[g, m]: the row of S that slice g holds in its m-th register row
    ids = torch.tensor([[4 * (gg + g * (m // 4)) + m % 4 if quad
                         else gg + g * m for m in range(rows)]
                        for gg in range(g)])
    S = (torch.zeros((b, h, n, n)) if state0 is None
         else state0.clone())
    u4 = u[None, :, :, None]
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]      # (B, H, n, n)
        term = r[:, i, :, :, None] * (S + u4 * kv)
        o = torch.zeros((b, h, g, n))                        # slice partials
        for m in range(rows):
            o = o + term[:, :, ids[:, m]]
        x = 1
        while x < g:
            o = o + o[:, :, torch.arange(g) ^ x]
            x <<= 1
        outs.append(o[:, :, 0])
        S = w[:, i, :, :, None] * S + kv
    return torch.stack(outs, dim=1), S


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_thread_split_numerics_match_jax(case):
    """The redesigned kernel's order of sums, emulated, stays within the
    reference's pin (rtol 1e-5 + atol 1e-4) of the JAX op."""
    b, t, h, n, bt = case
    r, k, v, w, u, s0 = _wkv_inputs(b, t, h, n, seed=sum(case) + 7)
    want_o, want_s = jwkv6(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)),
                           block_t=bt, interpret=True)
    got_o, got_s = _wkv6_emulation(*(torch.tensor(a)
                                     for a in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-4)


def test_wkv6_ops_are_forward_only():
    r, k, v, w, u, _ = (torch.tensor(a) for a in _wkv_inputs(1, 4, 1, 8,
                                                               51))
    with pytest.raises(RuntimeError, match="forward-only"):
        wkv6(r, k.requires_grad_(True), v, w, u)


def test_kernels_refuse_cpu_tensors():
    q, k, v = (torch.tensor(a).transpose(1, 2)
               for a in _flash_inputs(1, 8, 8, 2, 2, 16, 52))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, k, v)
    r, kk, vv, w, u, s0 = (torch.tensor(a) for a in _wkv_inputs(1, 4, 1, 8,
                                                                 53))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_kernel(r, kk, vv, w, u, s0)


def test_new_sources_are_built():
    assert build.SOURCES["flash_attention"] == "flash_attention.cu"
    assert build.SOURCES["wkv6"] == "wkv6.cu"
    for name in ("flash_attention", "wkv6"):
        assert (build.CSRC / build.SOURCES[name]).is_file()
        assert build.library_path(name).suffix == ".so"


# ---------------------------------------------------------------------------
# the CUDA kernels (GPU only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version_on_gpu(cuda, case, dtype):
    b, sq, sk, h, hkv, d, causal, win = case
    q, k, v = (torch.tensor(a, device=cuda).to(dtype).transpose(1, 2)
               for a in _flash_inputs(b, sq, sk, h, hkv, d, seed=sum(case)))
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    # bf16: both round their fp32 result once, at most one ulp apart
    tol = (dict(rtol=0, atol=2e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-5))
    torch.testing.assert_close(got.float(), attention_ref(
        q, k, v, causal=causal, window=win).float(), **tol)


@pytest.mark.gpu
def test_flash_kernel_fully_masked_rows_on_gpu(cuda):
    q, k, v = (torch.tensor(a, device=cuda).transpose(1, 2)
               for a in _flash_inputs(2, 70, 150, 4, 2, 64, seed=60))
    kw = dict(window=16, q_offset=100, seq_k_valid=100)
    got = flash_attention_kernel(q, k, v, **kw)
    torch.testing.assert_close(got, attention_ref(q, k, v, **kw), rtol=0,
                               atol=2e-5)


@pytest.mark.gpu
def test_flash_kernel_fully_masked_rows_bf16_on_gpu(cuda):
    q, k, v = (torch.tensor(a, device=cuda).to(torch.bfloat16).transpose(1, 2)
               for a in _flash_inputs(2, 70, 150, 4, 2, 64, seed=60))
    kw = dict(window=16, q_offset=100, seq_k_valid=100)
    got = flash_attention_kernel(q, k, v, **kw)
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, **kw)
                               .float(), **BF16_PIN)


def _gpu_tol(dtype):
    return dict(rtol=0, atol=2e-5) if dtype == torch.float32 else BF16_PIN


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_q_offset_on_gpu(cuda, dtype):
    """Sq < Sk: the last 100 rows of a 300-token sequence."""
    q, k, v = (torch.tensor(a, device=cuda).to(dtype).transpose(1, 2)
               for a in _flash_inputs(1, 100, 300, 8, 2, 128, seed=61))
    got = flash_attention_kernel(q, k, v, q_offset=200)
    torch.testing.assert_close(got.float(), attention_ref(
        q, k, v, q_offset=200).float(), **_gpu_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_ragged_tiles_on_gpu(cuda, dtype, causal):
    """Sq = 130 and Sk = 190: neither a multiple of the 128-row q tile nor
    of the 128-key kv block."""
    q, k, v = (torch.tensor(a, device=cuda).to(dtype).transpose(1, 2)
               for a in _flash_inputs(2, 130, 190, 4, 2, 128, seed=62))
    got = flash_attention_kernel(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), attention_ref(
        q, k, v, causal=causal).float(), **_gpu_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("view", ["head stride of 136 bytes",
                                  "address off by 2 bytes"])
def test_flash_kernel_refuses_what_tma_cannot_take_on_gpu(cuda, view):
    k, v = (torch.randn(1, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    if view == "head stride of 136 bytes":
        q = torch.randn(1, 16, 2, 68, device=cuda,
                        dtype=torch.bfloat16)[..., :64]
    else:
        q = torch.randn(1 * 16 * 2 * 64 + 1, device=cuda,
                        dtype=torch.bfloat16)[1:].view(1, 16, 2, 64)
    before = flash_attention_kernel.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_kernel(q.transpose(1, 2), k, v)
    assert flash_attention_kernel.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 80, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_takes_every_head_dim_on_gpu(cuda, d, dtype):
    """Padded to 32 / 128 / 128 by the op, 256 as it is (bf16 on the
    tensor cores at every head_dim, fp32 on the CUDA cores), within the
    unchanged pins."""
    q, k, v = (torch.tensor(a, device=cuda).to(dtype) for a in
               _flash_inputs(2, 150, 150, 4, 2, d, seed=63 + d))
    before = flash_attention_kernel.launches
    got = flash_attention(q, k, v, causal=True, window=64)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                         window=64).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), **_gpu_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("view", ["head stride of 136 bytes",
                                  "address off by 2 bytes"])
def test_flash_op_copies_what_tma_cannot_take_on_gpu(cuda, view):
    k, v = (torch.randn(1, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    if view == "head stride of 136 bytes":
        q = torch.randn(1, 16, 2, 68, device=cuda,
                        dtype=torch.bfloat16)[..., :64]
    else:
        q = torch.randn(1 * 16 * 2 * 64 + 1, device=cuda,
                        dtype=torch.bfloat16)[1:].view(1, 16, 2, 64)
    got = flash_attention(q, k, v)
    want = attention_ref(*(t.transpose(1, 2) for t in (q, k, v))
                         ).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), **BF16_PIN)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TC_CASES_256)
def test_flash_kernel_head_dim_256_bf16_on_gpu(cuda, case):
    """bf16 at D = 256 on the tensor cores (64-key blocks) against the
    plain version at the bf16 pin: GQA 16/1 with a window, q_offset with
    Sq < Sk, rows with no key, ragged tiles."""
    causal, window, q_offset, skv = case[6:]
    q, k, v = (t.to(cuda) for t in _tc_case_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              seq_k_valid=skv)
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, **kw)
                               .float(), **BF16_PIN)


@pytest.mark.gpu
def test_flash_head_dim_256_bf16_refuses_and_the_op_copies_on_gpu(cuda):
    """A bf16 D = 256 q whose head stride TMA cannot take (516 bytes)
    raises at the kernel, launching nothing; the op copies it and
    matches the plain version."""
    k, v = (torch.randn(1, 16, 2, 256, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    q = torch.randn(1, 16, 2, 258, device=cuda,
                    dtype=torch.bfloat16)[..., :256]
    before = flash_attention_kernel.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_kernel(*(t.transpose(1, 2) for t in (q, k, v)))
    assert flash_attention_kernel.launches == before
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    want = attention_ref(*(t.transpose(1, 2) for t in (q, k, v))
                         ).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), **BF16_PIN)


@pytest.mark.gpu
def test_flash_tensor_core_tiles_fit_on_gpu(cuda):
    """Every bf16 tile fits a block's 227 KB of shared memory, and the
    built kernel's kv block at each D is the one the CPU emulation takes
    (``TC_BLOCK_K``)."""
    for d in HEAD_DIMS:
        assert 0 < smem_bytes(torch.bfloat16, d) <= 232_448, d
        assert tc_block_k(d) == TC_BLOCK_K[d], d


def _offset(a, cuda, off):
    """``a`` on the card ``off`` elements past a fresh allocation: a
    contiguous tensor whose address is not 16-byte aligned for off % 4."""
    flat = torch.empty(a.size + off, dtype=torch.float32, device=cuda)
    t = flat[off:].view(a.shape)
    t.copy_(torch.tensor(a))
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("t", [31, 33, 257])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("off", [0, 1])
def test_wkv6_kernel_chunk_and_alignment_edges_on_gpu(cuda, t, n, off):
    """T not a multiple of the chunk (2048 / N steps), every N the kernel
    is built for, and inputs 4 bytes off a 16-byte boundary (the 4-byte
    copy path)."""
    args = [_offset(a, cuda, off)
            for a in _wkv_inputs(2, t, 3, n, seed=t + n + off)]
    got_o, got_s = wkv6_kernel(*args)
    torch.cuda.synchronize()
    want_o, want_s = wkv6_ref(*args)
    torch.testing.assert_close(got_o, want_o, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16, 64])
def test_wkv6_kernel_chained_halves_equal_one_pass_on_gpu(cuda, n):
    r, k, v, w, u, s0 = (torch.tensor(a, device=cuda)
                         for a in _wkv_inputs(2, 300, 4, n, seed=64 + n))
    full, sT = wkv6_kernel(r, k, v, w, u, s0)
    h1, s1 = wkv6_kernel(*(a[:, :137].contiguous() for a in (r, k, v, w)),
                         u, s0)
    h2, s2 = wkv6_kernel(*(a[:, 137:].contiguous() for a in (r, k, v, w)),
                         u, s1)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([h1, h2], 1), full)
    assert torch.equal(s2, sT)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_kernel_matches_plain_version_on_gpu(cuda, case):
    b, t, h, n, _ = case
    args = [torch.tensor(a, device=cuda)
            for a in _wkv_inputs(b, t, h, n, seed=sum(case))]
    before = wkv6_kernel.launches
    got_o, got_s = wkv6_kernel(*args)
    torch.cuda.synchronize()
    assert wkv6_kernel.launches == before + 1
    want_o, want_s = wkv6_ref(*args)
    torch.testing.assert_close(got_o, want_o, rtol=0, atol=1e-4)
    torch.testing.assert_close(got_s, want_s, rtol=0, atol=1e-4)


if __name__ == "__main__":
    # outputs outside the bf16 pin: P split into hi + lo vs rounded once
    for case in TC_CASES + TC_CASES_256 + [
            (1, 2048, 2048, 4, 4, 128, True, 0, 0, None),
            (1, 2048, 2048, 4, 4, 256, True, 0, 0, None)]:
        q, k, v = _tc_case_inputs(case)
        kw = dict(causal=case[6], window=case[7], q_offset=case[8],
                  seq_k_valid=case[9])
        want = attention_ref(q, k, v, **kw).float()
        line = []
        for split in (True, False):
            got = _tc_emulation(q, k, v, split=split,
                                block_k=TC_BLOCK_K[case[5]], **kw).float()
            bad = int((~torch.isclose(got, want, **BF16_PIN)).sum())
            line.append(f"{'split' if split else 'single'} {bad}/"
                        f"{got.numel()} ({100 * bad / got.numel():.2f}%), "
                        f"max abs {float((got - want).abs().max()):.3e}")
        print(case, "; ".join(line))
