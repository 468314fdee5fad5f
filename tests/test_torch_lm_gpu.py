"""The LM paths' new shapes on the card (``gpu``-marked; they skip without
CUDA).

The flash_attention kernel against its plain version at the attention
layers the new architectures give it, at their full width (B 2, S 2048):
recurrentgemma-9b's 16 heads on 1 kv head of 256 with a 2048 window (the
CUDA-core kernel), granite-20b's 48 heads on 1 and llama3-405b's 128 on
8 (bf16 on the tensor cores; fp32 on the CUDA cores).  And two MoE
forwards at olmoe-1b-7b's routing, equal bit for bit: the combine has no
float atomics.  This file imports no JAX: the card's results are held
against the port's plain versions.
"""
import pytest
import torch

from repro_torch.config import MoEConfig
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import moe as M

# bf16: kernel and plain version each round their fp32 result once, so
# they differ by at most one bf16 ulp; fp32: sums over up to 2048 keys in
# another order
TOL = {torch.float32: dict(rtol=0, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
# (heads, kv heads, head_dim, window) of recurrentgemma-9b, granite-20b,
# llama3-405b
SHAPES = {"recurrentgemma-9b": (16, 1, 256, 2048), "granite-20b":
          (48, 1, 128, 0), "llama3-405b": (128, 8, 128, 0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the flash_attention kernel has no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
