"""The training flash-attention op (``kernels/flash_attention/train.py``,
``csrc/flash_attention_train.cu``) and the dispatch that sends
``models.layers.attention`` to it.

On the CPU: the dispatch rule (CPU tensors, fp32, ``kv_valid``, positions
that are not one tensor and head_dims the kernels are not built for take
the plain path, bit for bit as before) and the ``attn_kernel`` /
``attn_plain`` counters.  On the card (``gpu``-marked, skipped without
CUDA): the forward, the log-sum-exp and dQ, dK, dV against a float64
oracle of the same bf16 inputs, within twice the plain chunked path's
error against that oracle, at the two training cells' shapes and at small
awkward ones; repeat runs equal bit for bit; launch counts; and a tiny
bf16 MLA train step whose ``remat`` "full" and "none" agree.  This file
imports no JAX.
"""
import pytest
import torch
from _torch_fixtures import cuda, one_thread  # noqa: F401

from repro_torch.config import reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic_lm_batch
from repro_torch.kernels.flash_attention import train as FT
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.obs.trace import Tracer, span, tracing
from repro_torch.runtime import make_train_step
from repro_torch.tree import leaves, value_and_grad

BF16 = torch.bfloat16


def _qkv(b, s, h, hkv, dqk, dv, dtype=BF16, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(n, d):
        return torch.randn((b, s, n, d), generator=gen, device=device,
                           dtype=torch.float32).to(dtype)
    return draw(h, dqk), draw(hkv, dqk), draw(hkv, dv)


# ---------------------------------------------------------------------------
# the dispatch rule, on the CPU
# ---------------------------------------------------------------------------

# (Dqk, Dv, dtype, kv_valid, length): every call that has to keep today's
# plain path, the full einsum (length <= 1024) and the chunked loop
PLAIN_CASES = [(192, 128, BF16, False, 40), (192, 128, BF16, False, 1100),
               (128, 128, torch.float32, False, 40),
               (128, 128, torch.float32, False, 1100),
               (128, 128, BF16, True, 40), (64, 64, BF16, False, 40),
               (256, 256, BF16, False, 40)]


@pytest.mark.parametrize("dqk,dv,dtype,with_valid,s", PLAIN_CASES)
def test_plain_calls_keep_todays_path_bit_for_bit(dqk, dv, dtype,
                                                  with_valid, s):
    q, k, v = _qkv(1, s, 4, 2, dqk, dv, dtype)
    pos = torch.arange(s)
    valid = (torch.arange(s)[None] < s - 3) if with_valid else None
    assert not FT.takes(q, k, v, pos, pos, valid)
    got = L.attention(q, k, v, pos, pos, window=0, kv_valid=valid)
    plain = L.attention_full if s <= 1024 else L.attention_chunked
    assert torch.equal(got, plain(q, k, v, pos, pos, 0, valid))


def test_shape_rule():
    """What the kernels take besides device and dtype: one position
    tensor for queries and keys, no ``kv_valid``, Lq == Lk, the built
    (Dqk, Dv), grouped heads."""
    q, k, v = _qkv(2, 48, 4, 2, 192, 128)
    pos = torch.arange(48)
    assert FT.shapes_ok(q, k, v, pos, pos, None)
    assert not FT.takes(q, k, v, pos, pos, None)            # on the CPU
    assert not FT.shapes_ok(q, k, v, pos, torch.arange(48), None)
    assert not FT.shapes_ok(q, k, v, pos, pos, torch.ones(2, 48).bool())
    assert not FT.shapes_ok(q[:, :40], k, v, pos[:40], pos[:40], None)
    assert not FT.shapes_ok(q, k, v, pos[None], pos[None], None)
    q2, k2, v2 = _qkv(1, 48, 4, 2, 128, 128)
    assert FT.shapes_ok(q2, k2, v2, pos, pos, None)
    for dqk, dv in ((64, 64), (256, 256), (192, 192), (128, 64)):
        q3, k3, v3 = _qkv(1, 48, 4, 2, dqk, dv)
        assert not FT.shapes_ok(q3, k3, v3, pos, pos, None)
    q4, k4, v4 = _qkv(1, 48, 6, 4, 128, 128)                # 6 % 4 != 0
    assert not FT.shapes_ok(q4, k4, v4, pos, pos, None)


def test_positions_are_one_when_they_share_their_memory():
    """Self-attention is read from the position tensors without looking at
    their values: one tensor, or views of the same memory with the same
    shape, strides and dtype; equal values elsewhere are two tensors."""
    q, k, v = _qkv(1, 48, 4, 2, 128, 128)
    pos = torch.arange(48)
    for same in (pos, pos[:], pos.view(48), pos.expand(48)):
        assert FT.same_positions(pos, same)
        assert FT.shapes_ok(q, k, v, pos, same, None)
    base = torch.arange(96)
    for other in (torch.arange(48), pos.clone(), pos.to(torch.int32),
                  base[::2], base[48:]):
        assert not FT.same_positions(pos, other)
        assert not FT.shapes_ok(q, k, v, pos, other, None)


def test_counters_count_under_a_tracer_and_not_without(monkeypatch):
    q, k, v = _qkv(1, 32, 2, 2, 128, 128)
    pos = torch.arange(32)
    tracer = Tracer("attn")
    with tracing(tracer), span("step"):
        L.attention(q, k, v, pos, pos)
        L.attention(q, k, v, pos, pos)
    assert tracer.counters[None] == {"attn_kernel": 0, "attn_plain": 2}

    # the kernel route counts attn_kernel (the op stubbed by the plain
    # path: the kernels have no CPU mode)
    monkeypatch.setattr(FT, "takes", lambda *a: True)
    monkeypatch.setattr(FT, "flash_attention_train",
                        lambda q, k, v, pos, window, scale:
                        L.attention_full(q, k, v, pos, pos, window))
    tracer = Tracer("attn")
    with tracing(tracer), span("step"):
        L.attention(q, k, v, pos, pos)
    assert tracer.counters[None] == {"attn_kernel": 1, "attn_plain": 0}

    def refuse(*a, **kw):
        raise AssertionError("counted without a tracer")
    monkeypatch.setattr(Tracer, "add_count", refuse)
    L.attention(q, k, v, pos, pos)


@pytest.mark.parametrize("dqk", [192, 128])
def test_op_counts_the_plain_paths_operations(monkeypatch, dqk):
    """``FlopCounterMode`` (which the dry run's check against the card
    uses) counts the op's forward and backward as the plain chunked path's
    products, the kernels stubbed by plain versions (they have no CPU
    mode)."""
    from torch.utils.flop_counter import FlopCounterMode
    q, k, v = _qkv(1, 2048, 2, 2, dqk, 128)
    pos = torch.arange(2048)

    def fwd(q, k, v, pos, window, scale, keep_o32=True):
        b, s, h, _ = q.shape
        o = torch.zeros((b, s, h, v.shape[-1]), dtype=q.dtype)
        return o, o.float(), torch.zeros((b, h, s)), pos.view(2, -1).clone()
    monkeypatch.setattr(FT, "flash_train_fwd_kernel", fwd)
    monkeypatch.setattr(FT, "flash_train_bwd_kernel",
                        lambda q, k, v, *rest: (torch.zeros_like(q),
                                                torch.zeros_like(k),
                                                torch.zeros_like(v)))
    counts = []
    for run in (lambda q, k, v: FT.FlashAttentionTrain.apply(
                    q, k, v, pos, 0, dqk ** -0.5),
                lambda q, k, v: L.attention_chunked(q, k, v, pos, pos)):
        leaves_ = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with FlopCounterMode(display=False) as fc:
            run(*leaves_).float().sum().backward()
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] == 3 * 2 * 2048 ** 2 * 2 * (dqk + 128)


def test_train_step_still_refuses_the_forward_only_kernel():
    cfg = reduce_for_smoke(get_config("qwen3-14b", "train_4k"), seq_len=16)
    with pytest.raises(ValueError, match="forward-only"):
        make_train_step(cfg.override({"parallel.use_flash_kernel": True}))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def positions(kind: str, s: int, device) -> torch.Tensor:
    """A position vector: ``arange``, the encoder's ``zeros``, a
    ``shuffled`` arange, or ``sorted`` random positions with gaps and
    ties."""
    gen = torch.Generator().manual_seed(s)
    if kind == "arange":
        pos = torch.arange(s)
    elif kind == "zeros":
        pos = torch.zeros(s, dtype=torch.int64)
    elif kind == "shuffled":
        pos = torch.randperm(s, generator=gen)
    else:
        pos = torch.sort(torch.randint(0, 2 * s, (s,), generator=gen))[0]
    return pos.to(device)


def oracle(q, k, v, do, pos, window, scale):
    """float64 attention of the same bf16 values, a head at a time: o,
    lse, dq, dk, dv; and ``lse_plain``, the log-sum-exp as the plain
    chunked path holds it (fp32 scores, a running max and sum over chunks
    of 1024 keys)."""
    b, s, h, _ = q.shape
    grp = h // k.shape[2]
    f64 = torch.float64
    mask = L.attention_scores_mask(pos, pos, window)
    o = torch.empty(v.shape[:2] + (h, v.shape[-1]), dtype=f64,
                    device=q.device)
    lse = torch.empty((b, h, s), dtype=f64, device=q.device)
    lse_plain = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=f64, device=q.device)
    dk = torch.zeros(k.shape, dtype=f64, device=q.device)
    dv = torch.zeros(v.shape, dtype=f64, device=q.device)
    for bi in range(b):
        for hi in range(h):
            kh, vh = k[bi, :, hi // grp], v[bi, :, hi // grp]
            qd, kd, vd = q[bi, :, hi].to(f64), kh.to(f64), vh.to(f64)
            gd = do[bi, :, hi].to(f64)
            sc = (qd @ kd.T * scale).masked_fill(~mask, -float("inf"))
            lse[bi, hi] = torch.logsumexp(sc, -1)
            m = torch.full((s,), L.NEG_INF, device=q.device)
            l = torch.zeros((s,), device=q.device)
            for c0 in range(0, s, 1024):
                s32 = torch.where(mask[:, c0:c0 + 1024],
                                  (q[bi, :, hi].float()
                                   @ kh[c0:c0 + 1024].float().T) * scale,
                                  L.NEG_INF)
                m_new = torch.maximum(m, s32.amax(-1))
                l = l * torch.exp(m - m_new) + torch.exp(
                    s32 - m_new[:, None]).sum(-1)
                m = m_new
            lse_plain[bi, hi] = m + torch.log(l)
            p = torch.exp(sc - lse[bi, hi, :, None])
            o[bi, :, hi] = p @ vd
            dp = gd @ vd.T
            ds = p * (dp - (dp * p).sum(-1, keepdim=True))
            dq[bi, :, hi] = scale * ds @ kd
            dk[bi, :, hi // grp] += scale * ds.T @ qd
            dv[bi, :, hi // grp] += p.T @ gd
    return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv,
            "lse_plain": lse_plain}


def rel_err(x, ref):
    """||x - ref|| / ||ref|| in float64."""
    ref = ref.to(torch.float64)
    return float((x.to(torch.float64) - ref).norm() / ref.norm())


def kernel_run(q, k, v, do, pos, window, scale):
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = FT.flash_attention_train(qq, kk, vv, pos, window=window, scale=scale)
    o.backward(do)
    return {"o": o.detach(), "dq": qq.grad, "dk": kk.grad, "dv": vv.grad}


def chunked_run(q, k, v, do, pos, window, scale):
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = L.attention_chunked(qq, kk, vv, pos, pos, window, scale=scale)
    o.backward(do)
    return {"o": o.detach(), "dq": qq.grad, "dk": kk.grad, "dv": vv.grad}


def errors(b, s, h, hkv, dqk, dv, window, kind, dev, seed=0):
    """The kernel's and the chunked path's errors against the oracle, each
    output (the log-sum-exp: the kernel's and the chunked path's own)."""
    q, k, v = _qkv(b, s, h, hkv, dqk, dv, device=dev, seed=seed)
    do = _qkv(b, s, h, h, dv, dv, device=dev, seed=seed + 1)[0]
    pos = positions(kind, s, dev)
    scale = dqk ** -0.5
    ref = oracle(q, k, v, do, pos, window, scale)
    got = kernel_run(q, k, v, do, pos, window, scale)
    lse = FT.flash_train_fwd_kernel(q, k, v, pos, window, scale)[2][..., :s]
    plain = chunked_run(q, k, v, do, pos, window, scale)
    out = {n: (rel_err(got[n], ref[n]), rel_err(plain[n], ref[n]))
           for n in ("o", "dq", "dk", "dv")}
    out["lse"] = (rel_err(lse, ref["lse"]),
                  rel_err(ref["lse_plain"], ref["lse"]))
    return out


# (B, S, H, Hkv, Dqk, Dv, window, positions): the two training cells' shapes
# (DeepSeek-V2-Lite's MLA at 8192, OLMoE's attention at 4096), then a
# length off the tiles, a window, GQA 4:1, batch 2, positions that are not
# an arange
FULL = [(1, 8192, 16, 16, 192, 128, 0, "arange"),
        (1, 4096, 16, 16, 128, 128, 0, "arange")]
SMALL = [(1, 1000, 2, 2, 192, 128, 0, "arange"),
         (2, 640, 2, 2, 128, 128, 200, "arange"),
         (1, 777, 8, 2, 128, 128, 0, "arange"),
         (1, 520, 4, 1, 192, 128, 64, "sorted"),
         (1, 512, 2, 2, 192, 128, 0, "zeros"),
         (1, 600, 2, 2, 128, 128, 0, "shuffled"),
         (2, 300, 4, 2, 192, 128, 100, "shuffled")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FULL + SMALL,
                         ids=lambda c: "-".join(map(str, c)))
def test_errors_within_twice_the_plain_paths_on_gpu(cuda, case):
    got = errors(*case, cuda)
    for name, (kernel, plain) in got.items():
        assert kernel <= 2 * plain, (name, kernel, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [FULL[0], SMALL[3]],
                         ids=lambda c: "-".join(map(str, c)))
def test_repeat_runs_equal_bit_for_bit_on_gpu(cuda, case):
    b, s, h, hkv, dqk, dv, window, kind = case
    q, k, v = _qkv(b, s, h, hkv, dqk, dv, device=cuda, seed=5)
    do = _qkv(b, s, h, h, dv, dv, device=cuda, seed=6)[0]
    pos = positions(kind, s, cuda)
    one = kernel_run(q, k, v, do, pos, window, dqk ** -0.5)
    two = kernel_run(q, k, v, do, pos, window, dqk ** -0.5)
    for name in one:
        assert torch.equal(one[name], two[name]), name


@pytest.mark.gpu
def test_attention_routes_by_dtype_and_counts_launches_on_gpu(cuda):
    q, k, v = _qkv(1, 300, 4, 2, 128, 128, device=cuda)
    pos = torch.arange(300, device=cuda)
    before = (FT.flash_train_fwd_kernel.launches,
              FT.flash_train_bwd_kernel.launches)
    qq = q.clone().requires_grad_(True)
    L.attention(qq, k, v, pos, pos).float().sum().backward()
    assert (FT.flash_train_fwd_kernel.launches,
            FT.flash_train_bwd_kernel.launches) == (before[0] + 1,
                                                    before[1] + 1)
    L.attention(q.float(), k.float(), v.float(), pos, pos)
    L.attention(q, k, v, pos, torch.arange(300, device=cuda))
    assert FT.flash_train_fwd_kernel.launches == before[0] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", [FULL[1], SMALL[1], SMALL[3]],
                         ids=lambda c: "-".join(map(str, c)))
def test_forward_without_grad_keeps_nothing_and_gives_the_same_bits_on_gpu(
        cuda, case):
    """Where no gradient is asked for (``torch.no_grad``, as in prefill,
    or inputs that require none), one forward launch, no backward, no
    fp32 O, and O bit for bit the training forward's."""
    b, s, h, hkv, dqk, dv, window, kind = case
    q, k, v = _qkv(b, s, h, hkv, dqk, dv, device=cuda, seed=9)
    pos = positions(kind, s, cuda)
    qq = q.clone().requires_grad_(True)
    want = FT.flash_attention_train(qq, k, v, pos, window=window)
    assert want.grad_fn is not None
    o, o32, lse, _ = FT.flash_train_fwd_kernel(q, k, v, pos, window,
                                               dqk ** -0.5, keep_o32=False)
    assert o32.numel() == 0 and torch.equal(o, want.detach())
    assert torch.equal(lse, FT.flash_train_fwd_kernel(
        q, k, v, pos, window, dqk ** -0.5)[2])
    before = (FT.flash_train_fwd_kernel.launches,
              FT.flash_train_bwd_kernel.launches)
    with torch.no_grad():
        got = [L.attention(qq, k, v, pos, pos, window=window)]
    got.append(L.attention(q, k, v, pos, pos, window=window))
    for out in got:
        assert out.grad_fn is None and torch.equal(out, want.detach())
    assert (FT.flash_train_fwd_kernel.launches,
            FT.flash_train_bwd_kernel.launches) == (before[0] + 2, before[1])


@pytest.mark.gpu
def test_tiny_bf16_mla_step_remat_full_matches_none_on_gpu(cuda):
    """A 2-layer DeepSeek-V2-Lite at MLA's published head widths (nope
    128 + rope 64, v 128), bf16 products, 256 tokens: every attention call
    goes through the kernels, and ``remat`` "full" (the forward recomputed
    in the backward, through the op's forward again) gives the same loss
    bit for bit as "none", gradients within 1e-6 of each leaf's largest."""
    cfg = reduce_for_smoke(get_config("deepseek-v2-lite-16b", "train_4k"),
                           seq_len=256, batch=2).override(
        {"model.head_dim": 128, "model.mla.rope_head_dim": 64,
         "model.mla.v_head_dim": 128, "model.num_layers": 2})
    m = cfg.model
    batch = {k: torch.as_tensor(x, device=cuda) for k, x in
             synthetic_lm_batch(2, 256, m.vocab_size, seed=3).items()}
    params = T.lm_init(0, m, torch.float32, cuda)
    res = {}
    for remat in ("none", "full"):
        before = FT.flash_train_bwd_kernel.launches
        res[remat] = value_and_grad(
            lambda p, b: T.lm_loss(p, b, m, BF16, remat)[0])(params, batch)
        assert FT.flash_train_bwd_kernel.launches - before == 2
    assert torch.equal(res["full"][0], res["none"][0])
    for a, b in zip(leaves(res["full"][1]), leaves(res["none"][1])):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-30)
