"""The split-bf16 head GEMM (``kernels/head_gemm``, ``csrc/head_gemm.cu``)
and the dispatch that sends ``models.layers._f32_matmul`` to it.

On the CPU: the dispatch rule (CPU tensors, fp32 ``x``, bf16 ``w``, rows
under ``MIN_ROWS``, widths off TMA's alignment and a transposed weight
keep the plain form, bit for bit), the ``head_kernel`` / ``head_plain``
counters, the split's plain reference (hi + mid + lo == v exactly over
fp32's range, and how far it misses below ``EXACT_MIN``), the terms' sums
against float64 products, and the op's autograd and operation counts with
the kernels stood in for by their plain references.  On the card
(``gpu``-marked, skipped without CUDA): forward, dX and dW against a
float64 oracle at both LM cells' widths and on ragged shapes, within 1.5x
the plain cuBLAS fp32 product's error; repeat runs bit for bit; gradients
through autograd; launch counts.  This file imports no JAX.
"""
import pytest
import torch
from _torch_fixtures import cuda_fp32, one_thread  # noqa: F401

from repro_torch.kernels.head_gemm import kernel as K
from repro_torch.kernels.head_gemm import ops, ref
from repro_torch.models import layers as L
from repro_torch.obs.trace import Tracer, span, tracing

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64


def _xw(rows, d, v, device="cpu", seed=0, x_dtype=BF16, w_dtype=F32):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, d), generator=gen, device=device).to(x_dtype)
    w = (torch.randn((d, v), generator=gen, device=device) * 0.02).to(w_dtype)
    return x, w


# ---------------------------------------------------------------------------
# the dispatch rule, on the CPU
# ---------------------------------------------------------------------------

def test_shape_rule():
    x, w = _xw(ops.MIN_ROWS, 64, 136)
    assert ops.shapes_ok(x, w)
    assert ops.shapes_ok(x.reshape(2, -1, 64), w)           # (B, S, d)
    assert not ops.takes(x, w)                               # on the CPU
    assert not ops.shapes_ok(x[: ops.MIN_ROWS - 1], w)       # too few rows
    assert not ops.shapes_ok(x.float(), w)                   # fp32 x
    assert not ops.shapes_ok(x, w.to(BF16))                  # bf16 w
    x2, w2 = _xw(ops.MIN_ROWS, 60, 136)                      # d % 8
    assert not ops.shapes_ok(x2, w2)
    x3, w3 = _xw(ops.MIN_ROWS, 64, 132)                      # vocab % 8
    assert not ops.shapes_ok(x3, w3)
    wt = torch.randn(136, 64).t()                            # tied layout
    assert not ops.shapes_ok(x, wt)


@pytest.mark.parametrize("rows,d,v,x_dtype,w_dtype", [
    (ops.MIN_ROWS, 64, 136, BF16, F32), (8, 64, 136, BF16, F32),
    (ops.MIN_ROWS, 64, 136, F32, F32), (ops.MIN_ROWS, 60, 132, BF16, F32),
    (ops.MIN_ROWS, 64, 136, BF16, BF16)])
def test_plain_calls_keep_the_plain_form_bit_for_bit(rows, d, v, x_dtype,
                                                     w_dtype):
    x, w = _xw(rows, d, v, x_dtype=x_dtype, w_dtype=w_dtype)
    assert not ops.takes(x, w)
    assert torch.equal(L._f32_matmul(x, w), x.float() @ w.float())
    assert torch.equal(L.unembed_apply({"table": w.t()}, x),
                       x.float() @ w.float())


def test_counters_count_under_a_tracer_and_not_without(monkeypatch):
    x, w = _xw(16, 64, 136)
    tracer = Tracer("head")
    with tracing(tracer), span("step"):
        L._f32_matmul(x, w)
        L._f32_matmul(x, w)
    assert tracer.counters[None] == {"head_kernel": 0, "head_plain": 2}

    # the kernel route counts head_kernel (the op stubbed by the plain
    # form: the kernels have no CPU mode)
    monkeypatch.setattr(ops, "takes", lambda *a: True)
    monkeypatch.setattr(ops, "head_matmul", ops.head_matmul_plain)
    tracer = Tracer("head")
    with tracing(tracer), span("step"):
        L._f32_matmul(x, w)
    assert tracer.counters[None] == {"head_kernel": 1, "head_plain": 0}

    def refuse(*a, **kw):
        raise AssertionError("counted without a tracer")
    monkeypatch.setattr(Tracer, "add_count", refuse)
    L._f32_matmul(x, w)


# ---------------------------------------------------------------------------
# the split's plain reference
# ---------------------------------------------------------------------------

def _exact_sum(parts):
    return sum(p.to(F64) for p in parts)


def test_split_reconstructs_fp32_exactly():
    """hi + mid + lo == v for random values over fp32's whole normal range
    from ``EXACT_MIN``, both signs, and for the edge cases."""
    gen = torch.Generator().manual_seed(0)
    exps = torch.randint(-110, 127, (200_000,), generator=gen)
    mant = 1 + torch.rand(200_000, generator=gen, dtype=F64)
    sign = torch.where(torch.rand(200_000, generator=gen) < 0.5, -1.0, 1.0)
    v = (sign * mant * torch.pow(2.0, exps.to(F64))).to(F32)
    edge = torch.tensor([0.0, -0.0, ref.EXACT_MIN, -ref.EXACT_MIN, 1.0,
                         1 + 2 ** -23, 2 ** -8 + 2 ** -31, 3.3895e38,
                         torch.finfo(F32).eps], dtype=F32)
    for t in (v, edge):
        parts = ref.split3(t)
        assert all(p.dtype == BF16 for p in parts)
        assert torch.equal(_exact_sum(parts), t.to(F64))
        # each part is the rounding of what the ones before leave
        hi, mid, lo = (p.to(F64) for p in parts)
        assert torch.all((mid.abs() <= hi.abs() * 2 ** -8))
        assert torch.all((lo.abs() <= mid.abs() * 2 ** -8))


def test_split_edges_below_exact_min_and_at_the_top():
    """Below 2^-110 the lowest bit of v can fall under bf16's least
    subnormal (2^-133): the parts then miss v by at most 2^-133.  From
    ``EXACT_MAX`` up hi rounds to infinity."""
    v = torch.tensor([2.0 ** -120 * (1 + 2 ** -23), 2.0 ** -126 * 1.75,
                      -(2.0 ** -112) * (1 + 2 ** -22)], dtype=F32)
    miss = (_exact_sum(ref.split3(v)) - v.to(F64)).abs()
    assert float(miss.max()) > 0
    assert float(miss.max()) <= 2.0 ** -133
    top = torch.tensor([ref.EXACT_MAX, torch.finfo(F32).max], dtype=F32)
    assert torch.isinf(ref.split3(top)[0].float()).all()
    below = torch.nextafter(torch.tensor(ref.EXACT_MAX, dtype=F32),
                            torch.tensor(0.0))
    assert torch.equal(_exact_sum(ref.split3(below[None])), below[None]
                       .to(F64))


def test_row_err_weighs_each_row_by_its_own_scale():
    """The yardstick: 0 on the float64 product itself; an error of e in a
    row reads e over that row's largest |A|.|B|, whatever the other
    rows' scales."""
    a = torch.tensor([[1.0, -2.0], [1e-3, 3e-3]], dtype=F64)
    b = torch.tensor([[1.0, 4.0], [0.5, -1.0]], dtype=F64)
    oracle, scale = ref.oracle(a, b)
    assert torch.equal(oracle, a @ b)
    assert torch.equal(scale, a.abs() @ b.abs())
    assert ref.row_err(oracle, oracle, scale) == 0.0
    y = oracle.clone()
    y[1, 0] += 1e-6
    assert ref.row_err(y, oracle, scale) == pytest.approx(
        1e-6 / float(scale[1].max()), rel=1e-9)


@pytest.mark.parametrize("kind", ["fwd", "dw", "dx"])
def test_terms_sum_to_the_float64_product(kind):
    """The three terms of the forward and dW are the fp32 product's own
    products: their float64 sum is the float64 product (up to float64's
    rounding of the sums); dX's six miss by at most the three dropped
    terms: mid.lo and lo.mid at most 2^-8 x 2^-16 of a product, lo.lo
    2^-16 x 2^-16."""
    gen = torch.Generator().manual_seed(1)
    a32 = torch.randn((40, 96), generator=gen)
    b32 = torch.randn((96, 56), generator=gen) * 0.02
    if kind in ("fwd", "dw"):
        a_parts = [a32.to(BF16)]
        full = a_parts[0].to(F64) @ b32.to(F64)
    else:
        a_parts = list(ref.split3(a32))
        full = a32.to(F64) @ b32.to(F64)
    got = ref.split_product(a_parts, ref.split3(b32), ref.TERMS[kind])
    scale = (a32.to(F64).abs() @ b32.to(F64).abs())
    gap = float(((got - full).abs() / scale).max())
    assert gap <= (2 * 2.0 ** -24 + 2.0 ** -32 if kind == "dx"
                   else 1e-15), gap


# ---------------------------------------------------------------------------
# the op, its autograd and its counts, the kernels stood in for on the CPU
# ---------------------------------------------------------------------------

def _stub_kernels(monkeypatch):
    """The ops module's kernels replaced by their plain references (float64
    sums of the same terms, rounded to fp32): the op's plumbing runs on
    the CPU."""
    def split(t):
        return torch.stack(ref.split3(t))

    def fwd(x, w_parts):
        return ref.split_product([x], w_parts, ref.TERMS["fwd"]).to(F32)

    def dw(x, g_parts):
        return ref.split_product([x.T], g_parts, ref.TERMS["dw"]).to(F32)

    def dx(g_parts, w_parts):
        return ref.split_product(g_parts, [p.T for p in w_parts],
                                 ref.TERMS["dx"]).to(F32)
    for name, fn in (("head_split_kernel", split), ("head_fwd_kernel", fwd),
                     ("head_dw_kernel", dw), ("head_dx_kernel", dx)):
        monkeypatch.setattr(ops, name, fn)


def test_function_gradients_and_dtypes(monkeypatch):
    """dX comes back in x's dtype (autograd casts the op's fp32 dX, as the
    plain form's ``.to(torch.float32)`` does), dW in fp32; both match the
    plain form's gradients; one input without a gradient computes only
    the other's."""
    _stub_kernels(monkeypatch)
    x, w = _xw(48, 64, 136)
    g = torch.randn((48, 136)) * 1e-3
    got, want = [], []
    for fn, out in ((ops.HeadMatmul.apply, got),
                    (ops.head_matmul_plain, want)):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xx, ww)
        out += [y.detach(), *torch.autograd.grad(y, (xx, ww), g)]
    assert got[1].dtype == BF16 and got[2].dtype == F32
    assert torch.allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
    assert torch.allclose(got[1].float(), want[1].float(), rtol=1e-2,
                          atol=1e-6)
    assert torch.allclose(got[2], want[2], rtol=1e-5, atol=1e-8)
    calls = []
    monkeypatch.setattr(ops, "head_dx_kernel",
                        lambda *a: calls.append("dx") or pytest.fail("dX"))
    ww = w.clone().requires_grad_(True)
    (dw,) = torch.autograd.grad(ops.HeadMatmul.apply(x, ww), (ww,), g)
    assert torch.allclose(dw, want[2], rtol=1e-5, atol=1e-8) and not calls


def test_op_counts_the_plain_forms_operations(monkeypatch):
    """``FlopCounterMode`` (the dry run's check against the card) counts the
    op's forward and backward as the plain fp32 product's three
    2 M N K, not the split's bf16 products."""
    from torch.utils.flop_counter import FlopCounterMode
    _stub_kernels(monkeypatch)
    x, w = _xw(48, 64, 136)
    counts = []
    for fn in (ops.HeadMatmul.apply, ops.head_matmul_plain):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        with FlopCounterMode(display=False) as fc:
            fn(xx, ww).sum().backward()
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] == 3 * 2 * 48 * 64 * 136


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def product_errors(kind, m, n, k, dev, seed=0):
    """(kernel's error, cuBLAS fp32's error) against the float64 oracle of
    the same operands: forward x (m, k) . w, dW x^T . G with x (k, m), dX
    G (m, k) . w^T with w (n, k)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    if kind == "fwd":
        a, b = r(m, k).to(BF16), r(k, n) * 0.02
        got = K.head_fwd_kernel(a, K.head_split_kernel(b))
        plain, want = a.float() @ b, ref.oracle(a, b)
    elif kind == "dw":
        a, b = r(k, m).to(BF16), r(k, n) * 1e-6
        got = K.head_dw_kernel(a, K.head_split_kernel(b))
        plain, want = a.float().T @ b, ref.oracle(a.T, b)
    else:
        a, b = r(m, k) * 1e-6, r(n, k) * 0.02
        got = K.head_dx_kernel(K.head_split_kernel(a),
                               K.head_split_kernel(b))
        plain, want = a @ b.T, ref.oracle(a, b.T)
    return ref.row_err(got, *want), ref.row_err(plain, *want)


# (kind, M, N, K): a DeepSeek-V2-Lite micro-batch's forward, dW and dX (d
# 2048, vocab 102,400, 8192 tokens), an OLMoE one's (vocab 50,304, 4096
# tokens), then ragged shapes: rows, columns and depth off the tiles
FULL = [("fwd", 8192, 102400, 2048), ("dw", 2048, 102400, 8192),
        ("dx", 8192, 2048, 102400), ("fwd", 4096, 50304, 2048),
        ("dw", 2048, 50304, 4096), ("dx", 4096, 2048, 50304)]
RAGGED = [("fwd", 300, 1032, 200), ("dw", 136, 520, 1000),
          ("dx", 1000, 264, 840), ("fwd", 129, 136, 8), ("dx", 64, 8, 72),
          ("dw", 8, 128, 129)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FULL + RAGGED,
                         ids=lambda c: "-".join(map(str, c)))
def test_errors_within_the_plain_products_on_gpu(cuda_fp32, case):
    kernel, plain = product_errors(*case, cuda_fp32)
    assert kernel <= 1.5 * plain, (kernel, plain)


@pytest.mark.gpu
def test_split_pass_matches_its_reference_on_gpu(cuda_fp32):
    gen = torch.Generator(device=cuda_fp32).manual_seed(3)
    t = torch.randn((515, 264), generator=gen, device=cuda_fp32)
    t[0, :6] = torch.tensor([1e-30, -3e-38, 1e30, 0.0, 2.5e-36, -7.0])
    for src in (t, t[:, 8:136], t[1:, :]):                   # strided views
        got = K.head_split_kernel(src)
        assert got.shape == (3, *src.shape) and got.dtype == BF16
        for part, want in zip(got, ref.split3(src)):
            assert torch.equal(part, want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [FULL[0], RAGGED[2]],
                         ids=lambda c: "-".join(map(str, c)))
def test_repeat_runs_equal_bit_for_bit_on_gpu(cuda_fp32, case):
    kind, m, n, k = case
    x, w = _xw(m, k, n, device=cuda_fp32, seed=5)
    g = torch.randn((m, n), device=cuda_fp32) * 1e-6

    def run():
        xx = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        y = ops.HeadMatmul.apply(xx, ww)
        return (y.detach(), *torch.autograd.grad(y, (xx, ww), g))
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,v", [(1024, 2048, 50304), (600, 256, 1032)])
def test_gradients_through_autograd_on_gpu(cuda_fp32, rows, d, v):
    """``torch.autograd.grad`` through ``_f32_matmul`` (the kernels) and
    through the plain form: each gradient's error against float64, the
    kernel's within 1.5x the plain form's (dX of both rounded to bf16)."""
    x, w = _xw(rows, d, v, device=cuda_fp32, seed=7)
    g = torch.randn((rows, v), device=cuda_fp32) * 1e-5
    grads = {}
    for name, fn in (("kernel", L._f32_matmul),
                     ("plain", ops.head_matmul_plain)):
        xx = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        grads[name] = torch.autograd.grad(fn(xx, ww), (xx, ww), g)
    assert ops.takes(x, w)
    want = (ref.oracle(g, w.T), ref.oracle(x.T, g))
    for i, name in enumerate(("dx", "dw")):
        assert grads["kernel"][i].dtype == grads["plain"][i].dtype
        kernel = ref.row_err(grads["kernel"][i], *want[i])
        plain = ref.row_err(grads["plain"][i], *want[i])
        assert kernel <= 1.5 * plain, (name, kernel, plain)


@pytest.mark.gpu
def test_dispatch_and_launch_counts_on_gpu(cuda_fp32):
    """A training call launches the split of w and the forward, then the
    splits of G and w, dW and dX; a no-grad call the split and the forward
    alone; calls the rule refuses launch nothing."""
    wrappers = (K.head_split_kernel, K.head_fwd_kernel, K.head_dw_kernel,
                K.head_dx_kernel)
    x, w = _xw(2 * ops.MIN_ROWS, 256, 1032, device=cuda_fp32)

    def launched(fn):
        before = [f.launches for f in wrappers]
        fn()
        return tuple(f.launches - b for f, b in zip(wrappers, before))
    xx = x.clone().requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    assert launched(lambda: L._f32_matmul(xx, ww).sum().backward()) == (
        3, 1, 1, 1)
    with torch.no_grad():
        assert launched(lambda: L._f32_matmul(xx, ww)) == (1, 1, 0, 0)
    for xs, ws in ((x[: ops.MIN_ROWS - 1], w), (x.float(), w),
                   (x, w.to(BF16)), (x[:, :250], w[:250, :1030])):
        assert launched(lambda: L._f32_matmul(xs, ws)) == (0, 0, 0, 0)
