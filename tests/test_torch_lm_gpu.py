"""The LM paths' new shapes on the card (``gpu``-marked; they skip without
CUDA).

The flash_attention kernel against its plain version at the attention
layers the new architectures give it, at their full width (B 2, S 2048):
recurrentgemma-9b's 16 heads on 1 kv head of 256 with a 2048 window,
granite-20b's 48 heads on 1 and llama3-405b's 128 on 8 (bf16 on the
tensor cores at every head_dim; fp32 on the CUDA cores).  And two MoE
forwards at olmoe-1b-7b's routing, equal bit for bit: the combine has no
float atomics.  And LM training on the card (twins of
``tests/test_torch_train.py``): a train step against the same step on
the CPU, ``remat="full"`` against ``"none"``, the FSL cadence, and the
kernels refused under autograd.  This file imports no JAX: the card's
results are held against the port's plain versions and the CPU.
"""
import pytest
import torch
from _torch_fixtures import cuda, one_thread  # noqa: F401
from _torch_parity import paths as _paths

from repro_torch.config import MoEConfig, reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic_lm_batch
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.wkv6.kernel import wkv6_kernel
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.runtime import make_fsl_train_step, make_train_step
from repro_torch.tree import leaves, tree_map, value_and_grad

# bf16: kernel and plain version each round their fp32 result once, so
# they differ by at most one bf16 ulp; fp32: sums over up to 2048 keys in
# another order
TOL = {torch.float32: dict(rtol=0, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
# (heads, kv heads, head_dim, window) of recurrentgemma-9b, granite-20b,
# llama3-405b
SHAPES = {"recurrentgemma-9b": (16, 1, 256, 2048), "granite-20b":
          (48, 1, 128, 0), "llama3-405b": (128, 8, 128, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", list(SHAPES))
def test_flash_kernel_at_the_new_archs_shapes_on_gpu(cuda, arch, dtype):
    h, hkv, d, window = SHAPES[arch]
    gen = torch.Generator(device=cuda).manual_seed(len(arch))
    q, k, v = (torch.randn((2, 2048, n, d), generator=gen, device=cuda)
               .to(dtype).transpose(1, 2) for n in (h, hkv, hkv))
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=True, window=window)
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_moe_forwards_on_gpu_are_equal_bit_for_bit(cuda, dtype):
    """olmoe's routing (64 experts, top-8) over 2 x 512 tokens in 32
    dispatch groups: two forwards give the same bits, and in fp32 the
    card agrees with the CPU."""
    cfg = MoEConfig(num_experts=64, top_k=8, d_ff_expert=128,
                    router_aux_coef=0.01)
    p = M.moe_init(torch.Generator().manual_seed(0), 256, cfg)
    x = torch.randn((2, 512, 256), generator=torch.Generator().manual_seed(1))
    pc = {"router": {"w": p["router"]["w"].to(cuda)},
          "experts": {k: v.to(cuda) for k, v in p["experts"].items()}}
    xc = x.to(cuda).to(dtype)
    with torch.no_grad():
        a, aux_a = M.moe_apply(pc, xc, cfg, dtype)
        b, aux_b = M.moe_apply(pc, xc, cfg, dtype)
        cpu, cpu_aux = M.moe_apply(p, x, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    if dtype == torch.float32:
        torch.testing.assert_close(a.cpu(), cpu, rtol=0, atol=1e-5)
        torch.testing.assert_close(aux_a.cpu(), cpu_aux, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# LM training on the card
# ---------------------------------------------------------------------------

def _train_setup(arch, dev, over=None, seq=32, batch=4):
    cfg = reduce_for_smoke(get_config(arch, "train_4k"), seq_len=seq,
                           batch=batch).override(
        {"optim.name": "sgd", "optim.lr": 0.1, **(over or {})})
    m = cfg.model
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             synthetic_lm_batch(batch, seq, m.vocab_size, seed=3).items()}
    if m.encdec.enabled:
        batch["enc_embeds"] = 0.1 * torch.randn(
            (batch["tokens"].shape[0], m.encdec.encoder_seq, m.d_model),
            generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    return cfg, T.lm_init(0, m, torch.float32, dev), batch


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-14b", "whisper-base",
                                  "olmoe-1b-7b"])
def test_train_step_on_gpu_matches_cpu(cuda, arch):
    """fp32, TF32 off, SGD, 2 micro-batches: the parameters and the
    momentum (the clipped gradients) within 1e-5 of each leaf's largest
    value of the same step on the CPU (a key bias's of the tree's; not
    bit for bit: the card sums in other orders)."""
    cfg, params, batch = _train_setup(arch, cuda,
                                      {"parallel.microbatches": 2})
    runs = []
    for where in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(where), params)
        b = tree_map(lambda t: t.to(where), batch)
        runs.append(make_train_step(cfg)(p, make_optimizer(cfg.optim).init(p),
                                         b, 0))
    (gp, go, gm), (hp, ho, hm) = runs
    assert float(gm["loss"]) == pytest.approx(float(hm["loss"]), rel=1e-5)
    for card, host in ((gp, hp), (go["mom"], ho["mom"])):
        top = max(float(h.abs().max()) for h in leaves(host))
        for path, a, h in zip(_paths(host), leaves(card), leaves(host)):
            assert a.device.type == "cuda"
            err = float((a.cpu() - h).abs().max())
            # a key bias's gradient is 0 analytically (softmax cancels
            # q.b): its rounding noise is held against the tree's scale
            ref = top if path[-2:] == ("wk", "b") else float(h.abs().max())
            assert err <= 1e-5 * max(ref, 1e-30), path


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_remat_full_matches_none_on_gpu(cuda, arch):
    """The checkpointed stack recomputes the same forward on the card: the
    same loss bit for bit, gradients within 1e-6 of each leaf's largest
    (the backward's sums may take other orders)."""
    over = {"model.num_layers": 4} if arch == "recurrentgemma-9b" else {}
    cfg, params, batch = _train_setup(arch, cuda, over, seq=16, batch=2)
    m = cfg.model
    res = {r: value_and_grad(lambda p, b: T.lm_loss(p, b, m, None, r)[0])(
        params, batch) for r in ("none", "full")}
    assert torch.equal(res["full"][0], res["none"][0])
    for a, b in zip(leaves(res["full"][1]), leaves(res["none"][1])):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-30)


@pytest.mark.gpu
def test_fsl_cadence_on_gpu(cuda):
    """3 replicas, FedAvg every 2 steps: they differ after step 0 and are
    equal bit for bit after step 1."""
    n = 3
    cfg, params, _ = _train_setup("qwen3-14b", cuda,
                                  {"fsl.local_steps": 2})
    m = cfg.model
    cp = tree_map(lambda x: x[None].expand(n, *x.shape), params)
    co = tree_map(lambda x: x[None].expand(n, *x.shape),
                  make_optimizer(cfg.optim).init(params))
    step = make_fsl_train_step(cfg, n)
    for i in range(2):
        b = {k: torch.as_tensor(v, device=cuda).reshape(n, 4, -1) for k, v in
             synthetic_lm_batch(4 * n, 32, m.vocab_size, seed=i).items()}
        cp, co, _ = step(cp, co, b, i)
        equal = all(torch.equal(l[0], l[c]) for l in leaves(cp)
                    for c in range(1, n))
        assert equal == (i == 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-1.6b"])
def test_kernels_refuse_autograd_on_gpu(cuda, arch):
    """A loss through the kernels under autograd raises before a launch:
    the kernels are forward-only (and ``make_train_step`` refuses
    ``use_flash_kernel``)."""
    cfg, params, batch = _train_setup(arch, cuda, seq=16, batch=2)
    before = (flash_attention_kernel.launches, wkv6_kernel.launches)
    with pytest.raises(RuntimeError, match="forward-only"):
        value_and_grad(lambda p, b: T.lm_loss(p, b, cfg.model,
                                              use_kernel=True)[0])(
            params, batch)
    with pytest.raises(ValueError, match="forward-only"):
        make_train_step(cfg.override({"parallel.use_flash_kernel": True}))
    assert (flash_attention_kernel.launches, wkv6_kernel.launches) == before
