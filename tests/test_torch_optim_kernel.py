"""The AdamW kernels of ``repro_torch/kernels/adamw`` and the optimizer's
choice of path.

On the CPU: the table builder as a pure function of addresses, sizes,
dtypes and rows (the limits a launch, the vector mask, empty leaves, the
rows), the constants it shares with ``csrc/adamw.cu``, CPU leaves and
vmapped leaves taking the plain form, and the stacked update of C clients
as the vmapped update.  On the card (``gpu``-marked; they skip without
CUDA): the kernels against the plain form, bit for bit without a clip
and within 2e-6 with one, at both dtypes, ragged and misaligned leaves,
more leaves than a table holds, the stacked update against each client's
own, a device lr read without a host sync, one OLMoE train step and one
vectorized GAN round.  This file imports no JAX:
``tests/test_torch_train.py`` holds the optimizer against the JAX
reference.
"""
import re
from pathlib import Path

import pytest
import torch
from _torch_fixtures import cuda_fp32, one_thread  # noqa: F401

from repro_torch.kernels.adamw import kernel as K
from repro_torch.kernels.adamw.kernel import (adamw_leaves_kernel,
                                              build_tables,
                                              clip_scale_kernel)
from repro_torch.kernels.adamw.ops import (adamw_plain, adamw_update,
                                           adamw_update_stacked)
from repro_torch.optim import adamw, clip_by_global_norm, make_optimizer
from repro_torch.tree import leaves, tree_map

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
HP = dict(beta1=0.9, beta2=0.95, eps=1e-8)
# words of a table of n entries: 7 addresses, N, first (n + 1), kind, row,
# vec
WORDS = lambda n: 11 * n + 2  # noqa: E731


def _table(words, offset, n):
    """One launch's table split into its named parts."""
    t = list(words[offset:offset + WORDS(n)])
    names = ["g", "m", "v", "p", "po", "mo", "vo", "N"]
    out = {k: t[i * n:(i + 1) * n] for i, k in enumerate(names)}
    out["first"] = t[8 * n:9 * n + 1]
    out["kind"] = t[9 * n + 1:10 * n + 1]
    out["row"] = t[10 * n + 1:11 * n + 1]
    out["vec"] = t[11 * n + 1]
    return out


@pytest.mark.parametrize("n_leaves,per_launch", [
    (1, [1]), (48, [48]), (49, [48, 1]), (100, [48, 48, 4])])
def test_tables_hold_at_most_max_leaves(n_leaves, per_launch):
    ptrs = [tuple(4096 * (7 * l + k) for k in range(7))
            for l in range(n_leaves)]
    sizes = [1024 * (l + 1) for l in range(n_leaves)]
    words, launches = build_tables(ptrs, sizes, [0] * n_leaves)
    assert [n for _, n in launches] == per_launch
    assert [o for o, _ in launches] == [
        sum(WORDS(n) for n in per_launch[:i]) for i in range(len(launches))]
    assert len(words) == sum(map(WORDS, per_launch))
    at = 0
    for offset, n in launches:
        t = _table(words, offset, n)
        assert t["g"] == [ptrs[at + j][0] for j in range(n)]
        assert t["vo"] == [ptrs[at + j][6] for j in range(n)]
        assert t["N"] == sizes[at:at + n]
        # each leaf's chunks of BLOCK_ELEMS elements, in order
        assert t["first"] == [sum(-(-s // K.BLOCK_ELEMS)
                                  for s in sizes[at:at + j])
                              for j in range(n + 1)]
        assert t["vec"] == (1 << n) - 1
        assert t["row"] == [0] * n
        at += n


def test_empty_leaves_take_no_entry():
    ptrs = [tuple(64 * (7 * l + k) for k in range(7)) for l in range(5)]
    words, launches = build_tables(ptrs, [0, 3, 0, 8, 0], [0, 8, 0, 15, 0])
    assert launches == [(0, 2)]
    t = _table(words, 0, 2)
    assert t["p"] == [ptrs[1][3], ptrs[3][3]]
    assert t["N"] == [3, 8] and t["first"] == [0, 1, 2]
    assert t["kind"] == [8, 15]
    words, launches = build_tables(ptrs, [0] * 5, [0] * 5)
    assert len(words) == 0 and launches == []


def test_rows_go_in_the_tables_and_never_decrease():
    """Five stacked clients of 12 leaves: each entry's row in its table,
    the rows running on across the table boundary; rows that decrease are
    refused (the norm pass meets a row in one run of chunks)."""
    ptrs = [tuple(4096 * (7 * l + k) for k in range(7)) for l in range(60)]
    rows = [l // 12 for l in range(60)]
    words, launches = build_tables(ptrs, [64] * 60, [0] * 60, rows)
    assert [n for _, n in launches] == [48, 12]
    assert _table(words, *launches[0])["row"] == rows[:48]
    assert _table(words, *launches[1])["row"] == rows[48:]
    with pytest.raises(ValueError, match="rows decrease"):
        build_tables(ptrs[:2], [64, 64], [0, 0], [1, 0])


Z = (0,) * 7


@pytest.mark.parametrize("case,kind,size,offsets,vec", [
    ("aligned fp32", 0, 4096, Z, 1),
    ("ragged N", 0, 4097, Z, 0),
    ("N of 2", 0, 2, Z, 0),
    ("fp32 g 8 bytes off", 0, 4096, (8, 0, 0, 0, 0, 0, 0), 0),
    ("bf16 g 8 bytes off", 1, 4096, (8, 0, 0, 0, 0, 0, 0), 1),
    ("bf16 g 4 bytes off", 1, 4096, (4, 0, 0, 0, 0, 0, 0), 0),
    ("fp32 v' 4 bytes off", 0, 4096, (0, 0, 0, 0, 0, 0, 4), 0),
    ("bf16 v and v' 8 bytes off", 4, 4096, (0, 0, 8, 0, 0, 0, 8), 1),
    ("bf16 p and p' 8 bytes off", 8, 4096, (0, 0, 0, 8, 8, 0, 0), 1),
    ("bf16 p, fp32 m' 8 bytes off", 8, 4096, (0, 0, 0, 0, 0, 8, 0), 0),
])
def test_vector_mask_follows_sizes_and_alignment(case, kind, size, offsets,
                                                 vec):
    """Bit 0 for the leaf under test: N % 4 == 0 and each of its seven
    addresses aligned to 4 elements of its own dtype (16 bytes fp32, 8
    bf16); a second, aligned leaf keeps bit 1."""
    ptrs = tuple((1 << 20) + 4096 * k + o for k, o in enumerate(offsets))
    words, _ = build_tables([ptrs, (1 << 21,) * 7], [size, 64], [kind, 0])
    assert _table(words, 0, 2)["vec"] == vec | 2


def test_constants_match_the_kernel_source():
    src = (CSRC / "adamw.cu").read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)
    assert int(const("kLeaves")) == K.MAX_LEAVES
    assert const("kBlockElems") == "4 * kThreads"
    assert 4 * int(const("kThreads")) == K.BLOCK_ELEMS
    assert int(const("kNormBlocks")) == K.NORM_BLOCKS
    assert int(const("kMaxRows")) == K.MAX_ROWS
    bits = [int(b) for b in re.search(
        r"kGBf16 = (\d+), kMBf16 = (\d+), kVBf16 = (\d+), kPBf16 = (\d+);",
        src).groups()]
    assert tuple(bits) == K.KIND_BITS


def _tree(gen, shapes, dtype=torch.float32, positive=False, scale=1.0):
    out = {}
    for i, s in enumerate(shapes):
        x = torch.randn(s, generator=gen) * scale
        out[f"l{i:02d}"] = (x.abs() if positive else x).to(dtype)
    return out


def _state(gen, shapes, p_dtype=torch.float32, s_dtype=torch.float32,
           g_dtype=torch.float32):
    """grads, m, v, params of a tree some steps into training."""
    return (_tree(gen, shapes, g_dtype, scale=0.1),
            _tree(gen, shapes, s_dtype, scale=0.01),
            _tree(gen, shapes, s_dtype, positive=True, scale=1e-3),
            _tree(gen, shapes, p_dtype))


def _bc(step, device="cpu"):
    t = torch.tensor(float(step), device=device)
    return 1 - HP["beta1"] ** t, 1 - HP["beta2"] ** t


def _counts():
    return (adamw_leaves_kernel.launches, adamw_leaves_kernel.kernel_leaves,
            adamw_leaves_kernel.plain_leaves)


@pytest.mark.parametrize("grad_clip,weight_decay", [(0.0, 0.0), (0.0, 0.1),
                                                    (1.0, 0.1)])
def test_cpu_leaves_take_the_plain_form(grad_clip, weight_decay):
    gen = torch.Generator().manual_seed(0)
    g, m, v, p = _state(gen, [(3, 5), (7,), (2, 2, 2)])
    bc1, bc2 = _bc(3)
    hp = dict(HP, weight_decay=weight_decay, grad_clip=grad_clip)
    before = _counts()
    got = adamw_update(g, m, v, p, bc1, bc2, 1e-3, **hp)
    after = _counts()
    assert after[:2] == before[:2] and after[2] == before[2] + 3
    want = adamw_plain(g, m, v, p, bc1, bc2, 1e-3, **hp)
    for a, b in zip(got, want):
        assert all(map(torch.equal, leaves(a), leaves(b)))


def test_optimizer_update_is_the_plain_form_on_cpu():
    """``optimizers.adamw`` through the op: its step, bias corrections and
    state, the clipped gradient's first moment."""
    gen = torch.Generator().manual_seed(1)
    g, _, _, p = _state(gen, [(4, 3), (5,)])
    opt = adamw(**HP, weight_decay=0.1, grad_clip=0.5)
    state = opt.init(p)
    new_p, new_s = opt.update(g, state, p, torch.tensor(2e-3))
    assert int(new_s["step"]) == 1
    bc1, bc2 = _bc(1)
    want = adamw_plain(g, state["m"], state["v"], p, bc1, bc2,
                       torch.tensor(2e-3), **HP, weight_decay=0.1,
                       grad_clip=0.5)
    for a, b in zip((new_p, new_s["m"], new_s["v"]), want):
        assert all(map(torch.equal, leaves(a), leaves(b)))
    clipped, _ = clip_by_global_norm(g, 0.5)
    for mm, gc in zip(leaves(new_s["m"]), leaves(clipped)):
        torch.testing.assert_close(mm, (1 - HP["beta1"]) * gc)


def _stacked_vs_unbatched(device, update="vmapped", grad_clip=0.0,
                          shapes=((3, 4, 5), (3, 7), (3, 1))):
    """The update of 3 clients' stacked trees, ``update`` "vmapped" (the
    update vmapped over clients) or "stacked" (``update_stacked``),
    against each client's own update: (kernel leaves, plain leaves) the
    stacked call counted, the worst difference, and the stacked result."""
    gen = torch.Generator().manual_seed(2)
    g, m, v, p = (tree_map(lambda x: x.to(device), t)
                  for t in _state(gen, shapes))
    opt = adamw(beta1=0.5, beta2=0.999, eps=1e-8, weight_decay=0.1,
                grad_clip=grad_clip)
    state = {"m": m, "v": v,
             "step": torch.tensor([0, 2, 5], dtype=torch.int32,
                                  device=device)}
    lrs = torch.tensor([1e-3, 2e-3, 5e-4], device=device)
    fn = (torch.func.vmap(opt.update) if update == "vmapped"
          else opt.update_stacked)
    before = _counts()
    vp, vs = fn(g, state, p, lrs)
    after = _counts()
    worst = 0.0
    for c in range(3):
        one = lambda t: tree_map(lambda x: x[c], t)  # noqa: E731
        up, us = opt.update(one(g), {"m": one(m), "v": one(v),
                                     "step": state["step"][c]}, one(p),
                            float(lrs[c]))
        for a, b in zip(leaves(vp) + leaves(vs["m"]) + leaves(vs["v"]),
                        leaves(up) + leaves(us["m"]) + leaves(us["v"])):
            worst = max(worst, float((a[c] - b).abs().max()))
        assert int(vs["step"][c]) == int(us["step"])
    return after[1] - before[1], after[2] - before[2], worst, (vp, vs)


def test_vmapped_update_takes_the_plain_form():
    kernel_leaves, plain_leaves, worst, _ = _stacked_vs_unbatched("cpu")
    assert (kernel_leaves, plain_leaves) == (0, 3)
    assert worst <= 1e-6


@pytest.mark.parametrize("grad_clip", [0.0, 1e-3])
def test_stacked_update_is_the_vmapped_update_on_cpu(grad_clip):
    """``update_stacked`` on CPU leaves: the plain form vmapped over the
    clients, so the vectorized programs' CPU rounds keep their bits; each
    client's clip by its own norm (1e-3 clips every client here)."""
    k, plain, worst, (sp, ss) = _stacked_vs_unbatched("cpu", "stacked",
                                                      grad_clip)
    assert (k, plain) == (0, 9)
    assert worst <= 1e-6
    *_, (vp, vs) = _stacked_vs_unbatched("cpu", "vmapped", grad_clip)
    for a, b in zip(leaves(sp) + leaves(ss), leaves(vp) + leaves(vs)):
        assert torch.equal(a, b)


def test_stacked_update_needs_a_client_axis():
    x = torch.zeros(3, 4)
    bc = torch.ones(3)
    hp = dict(HP, weight_decay=0.0, grad_clip=0.0)
    with pytest.raises(ValueError, match="client axis"):
        adamw_update_stacked({"a": x}, {"a": x}, {"a": x},
                             {"a": torch.zeros(2, 4)}, bc, bc, bc, **hp)
    with pytest.raises(ValueError, match="client axis"):
        adamw_update_stacked({"a": x}, {"a": x}, {"a": x}, {"a": x},
                             torch.ones(()), torch.ones(()), 1e-3, **hp)


def test_kernel_refuses_what_it_does_not_take():
    x = torch.zeros(4)
    bc = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        adamw_leaves_kernel([x], [x], [x], [x], bc, bc, 1e-3, **HP,
                            weight_decay=0.0, grad_clip=0.0)
    with pytest.raises(ValueError, match="leaves"):
        adamw_leaves_kernel([x], [x], [], [x], bc, bc, 1e-3, **HP,
                            weight_decay=0.0, grad_clip=0.0)
    with pytest.raises(ValueError, match="no path"):
        adamw_update({"a": x}, {"a": x}, {"a": x},
                     {"a": torch.zeros(4, device="meta")}, bc, bc, 1e-3,
                     **HP, weight_decay=0.0, grad_clip=0.0)


# ---------------------------------------------------------------- the card

def _to(tree, dev):
    return tree_map(lambda x: x.to(dev), tree)


def _run_both(dev, trees, step, lr, **hp):
    """The kernel path and the plain form on the card, from the same
    inputs; the inputs checked unchanged after the kernel's call."""
    g, m, v, p = (_to(t, dev) for t in trees)
    copies = [tree_map(torch.clone, t) for t in (g, m, v, p)]
    bc1, bc2 = _bc(step, dev)
    hp = dict(HP, **hp)
    before = _counts()
    got = adamw_update(g, m, v, p, bc1, bc2, lr, **hp)
    after = _counts()
    want = adamw_plain(g, m, v, p, bc1, bc2, lr, **hp)
    for a, b in zip((g, m, v, p), copies):
        assert all(map(torch.equal, leaves(a), leaves(b)))
    n = len(leaves(p))
    assert after[1] - before[1] == n and after[2] == before[2]
    return got, want, after[0] - before[0]


def _bits_equal(got, want):
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32))


SHAPES = [(64, 48), (1000,), (4097,), (3,), (1,), (2, 3, 5), (256, 1030)]


@pytest.mark.gpu
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("dtypes", [
    ("fp32", torch.float32, torch.float32, torch.float32),
    ("bf16 state", torch.float32, torch.bfloat16, torch.float32),
    ("bf16 params and state", torch.bfloat16, torch.bfloat16,
     torch.float32),
    ("bf16 everything", torch.bfloat16, torch.bfloat16, torch.bfloat16)],
    ids=lambda d: d[0])
def test_kernel_has_the_plain_forms_bits_without_clip_on_gpu(
        cuda_fp32, weight_decay, dtypes):
    _, pd, sd, gd = dtypes
    gen = torch.Generator().manual_seed(3)
    trees = _state(gen, SHAPES, pd, sd, gd)
    got, want, launches = _run_both(cuda_fp32, trees, 3, 1e-3,
                                    weight_decay=weight_decay, grad_clip=0.0)
    assert launches == 1
    for a, b in zip(got, want):
        _bits_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_misaligned_and_ragged_leaves_on_gpu(cuda_fp32, offset):
    """Leaves that start 1-3 elements past an allocation's start (views of
    a larger buffer, as a stacked tree's rows are) and lengths that are
    not a multiple of 4: the scalar path, with the same bits."""
    gen = torch.Generator().manual_seed(4 + offset)
    sizes = [4096, 4097, 4099, 5, 2]
    trees = []
    for kind in _state(gen, [(n,) for n in sizes]):
        tree = {}
        for k, x in kind.items():
            buf = torch.zeros(x.numel() + offset, dtype=x.dtype,
                              device=cuda_fp32)
            tree[k] = buf[offset:]
            tree[k].copy_(x)
        trees.append(tree)
    g, m, v, p = trees
    bc1, bc2 = _bc(2, cuda_fp32)
    hp = dict(HP, weight_decay=0.1, grad_clip=0.0)
    got = adamw_update(g, m, v, p, bc1, bc2, 3e-4, **hp)
    want = adamw_plain(g, m, v, p, bc1, bc2, 3e-4, **hp)
    for a, b in zip(got, want):
        _bits_equal(a, b)


@pytest.mark.gpu
def test_permuted_gradients_on_gpu(cuda_fp32):
    """A convolution weight's gradient comes from autograd in the layout of
    the permuted view the forward took (HWIO weights read as OIHW): the
    op copies it into the parameter's order, with the plain form's bits."""
    gen = torch.Generator().manual_seed(8)
    shapes = [(5, 5, 64, 32), (5, 5, 32, 1), (100, 12544)]
    g, m, v, p = (_to(t, cuda_fp32) for t in _state(gen, shapes))
    g = {k: x.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
         if x.dim() == 4 else x for k, x in g.items()}
    assert [x.is_contiguous() for x in leaves(g)] == [False, False, True]
    bc1, bc2 = _bc(5, cuda_fp32)
    hp = dict(HP, weight_decay=0.0, grad_clip=0.0)
    before = _counts()
    got = adamw_update(g, m, v, p, bc1, bc2, 2e-4, **hp)
    assert _counts()[1] - before[1] == 3
    for a, b in zip(got, adamw_plain(g, m, v, p, bc1, bc2, 2e-4, **hp)):
        _bits_equal(a, b)


@pytest.mark.gpu
def test_more_leaves_than_a_table_holds_on_gpu(cuda_fp32):
    n = 2 * K.MAX_LEAVES + 5
    gen = torch.Generator().manual_seed(5)
    shapes = [(1 + 37 * i,) for i in range(n)] + [(0,)]
    trees = _state(gen, shapes)
    got, want, launches = _run_both(cuda_fp32, trees, 7, 1e-3,
                                    weight_decay=0.1, grad_clip=0.0)
    assert launches == 3
    for a, b in zip(got, want):
        _bits_equal(a, b)
    # under a clip: 3 norm launches, the scale, 3 updates
    got, want, launches = _run_both(cuda_fp32, trees, 7, 1e-3,
                                    weight_decay=0.1, grad_clip=1.0)
    assert launches == 7


@pytest.mark.gpu
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_clip_within_2e_6_and_deterministic_on_gpu(cuda_fp32, weight_decay):
    """Under a clip the norm is summed in another order than the plain
    form's: the results within 2e-6 relative (of each leaf's largest, for
    elements near 0), and two calls equal bit for bit."""
    gen = torch.Generator().manual_seed(6)
    trees = _state(gen, SHAPES + [(512, 512)])
    got, want, launches = _run_both(cuda_fp32, trees, 1, 1e-3,
                                    weight_decay=weight_decay, grad_clip=1.0)
    assert launches == 3
    for a, b in zip(got, want):
        for x, y in zip(leaves(a), leaves(b)):
            torch.testing.assert_close(x, y, rtol=2e-6,
                                       atol=2e-6 * float(y.abs().max()))
    again, _, _ = _run_both(cuda_fp32, trees, 1, 1e-3,
                            weight_decay=weight_decay, grad_clip=1.0)
    for a, b in zip(got, again):
        _bits_equal(a, b)
    g = _to(trees[0], cuda_fp32)
    norm = torch.sqrt(sum(torch.sum(torch.square(x)) for x in leaves(g)))
    want_scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-9), max=1.0)
    scale = clip_scale_kernel(leaves(g), 1.0)
    assert float(want_scale) < 1.0
    torch.testing.assert_close(scale, want_scale, rtol=2e-6, atol=0)
    assert torch.equal(scale, clip_scale_kernel(leaves(g), 1.0))


@pytest.mark.gpu
def test_lr_forms_give_the_same_bits_on_gpu(cuda_fp32):
    """lr as a CPU tensor (as the schedules give it) or a number, read on
    the host, or a device tensor, read by the kernel: the same value, the
    same bits, and no call synchronises with the host (PyTorch's sync
    debug mode at "error" raises on one)."""
    gen = torch.Generator().manual_seed(7)
    trees = _state(gen, SHAPES)
    g, m, v, p = (_to(t, cuda_fp32) for t in trees)
    bc1, bc2 = _bc(4, cuda_fp32)
    hp = dict(HP, weight_decay=0.0, grad_clip=1.0)
    lr = torch.tensor(7e-4)
    forms = (lr, lr.to(cuda_fp32), float(lr))
    adamw_update(g, m, v, p, bc1, bc2, lr, **hp)    # the library built
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [adamw_update(g, m, v, p, bc1, bc2, x, **hp) for x in forms]
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            _bits_equal(a, b)


@pytest.mark.gpu
def test_vmapped_update_is_refused_on_gpu(cuda_fp32):
    """A ``ctypes`` launch cannot run under ``torch.func.vmap``: on the
    card the vmapped update raises and launches nothing (the vectorized
    programs take ``update_stacked``)."""
    before = _counts()
    with pytest.raises(RuntimeError, match="data pointer"):
        _stacked_vs_unbatched(cuda_fp32)
    assert _counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", [
    ((3, 4, 5), (3, 7), (3, 1)),
    # 3 clients x 20 leaves: 60 entries, two tables, a client's rows
    # across the boundary; rows of 4097 and 6 elements off the vector path
    tuple((3, 1 + 13 * i) for i in range(18)) + ((3, 4097), (3, 2, 3))],
    ids=["3 leaves", "20 leaves"])
def test_stacked_update_is_each_clients_own_on_gpu(cuda_fp32, shapes):
    """``update_stacked`` of 3 clients on the card, through the kernels
    (every client's leaf counted, none plain), each client's rows bit for
    bit its own update's without a clip, and the plain form's vmapped
    over the clients on the card."""
    n = len(shapes)
    k, plain, worst, (sp, ss) = _stacked_vs_unbatched(
        cuda_fp32, "stacked", 0.0, shapes)
    assert (k, plain, worst) == (3 * n, 0, 0.0)
    gen = torch.Generator().manual_seed(2)
    g, m, v, p = (_to(t, cuda_fp32) for t in _state(gen, shapes))
    step = torch.tensor([1, 3, 6], dtype=torch.float32, device=cuda_fp32)
    bc1, bc2 = 1 - 0.5 ** step, 1 - 0.999 ** step
    lrs = torch.tensor([1e-3, 2e-3, 5e-4], device=cuda_fp32)
    hp = dict(beta1=0.5, beta2=0.999, eps=1e-8, weight_decay=0.1,
              grad_clip=0.0)
    want = torch.func.vmap(lambda *a: adamw_plain(*a, **hp))(
        g, m, v, p, bc1, bc2, lrs)
    _bits_equal(sp, want[0])
    _bits_equal(ss["m"], want[1])
    _bits_equal(ss["v"], want[2])


@pytest.mark.gpu
def test_stacked_clip_is_each_clients_own_on_gpu(cuda_fp32):
    """Under a clip each client's rows are clipped by that client's own
    global norm (1e-3 clips every client): within 2e-6 of its own update,
    norm, scale, update launches over two tables (5)."""
    shapes = tuple((3, 1 + 13 * i) for i in range(18)) + ((3, 4097),
                                                            (3, 2, 3))
    before = _counts()
    k, plain, worst, (sp, _) = _stacked_vs_unbatched(
        cuda_fp32, "stacked", 1e-3, shapes)
    assert (k, plain) == (60, 0)
    assert worst <= 2e-6 * max(float(x.abs().max()) for x in leaves(sp))
    # the stacked call's launches, then each client's own (3 each)
    assert _counts()[0] - before[0] == 5 + 3 * 3


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["loop", "vectorized"])
def test_gan_round_sends_every_leaf_through_the_kernel_on_gpu(cuda_fp32,
                                                              backend):
    """One dcgan-mnist round of 3 clients x 2 batches on the card: the
    server's 2 G steps and every client's D steps through the kernels,
    none plain; under ``vectorized`` one stacked call a step for the
    three clients."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gan import FSLGANTrainer
    from repro_torch.data import partition_dirichlet, synthetic_mnist
    imgs, labels = synthetic_mnist(180, seed=0)
    parts = partition_dirichlet(imgs, labels, 3, alpha=0.5, seed=0)
    tr = FSLGANTrainer(get_config("dcgan-mnist").override(
        {"shape.global_batch": 8, "fsl.num_clients": 3,
         "model.dcgan.base_filters": 8, "fed.backend": backend}), parts,
        seed=0, device=cuda_fp32)
    n_g = len(leaves(tr.state.g_params))
    n_d = len(leaves(tr.state.d_params["c0"]))
    d0 = {c: [x.clone() for x in leaves(d)]
          for c, d in tr.state.d_params.items()}
    before = _counts()
    tr.train_epoch(batches_per_client=2)
    after = _counts()
    per = lambda n: -(-n // K.MAX_LEAVES)  # noqa: E731
    d_launches = (3 * 2 * per(n_d) if backend == "loop"
                  else 2 * per(3 * n_d))
    assert tuple(a - b for a, b in zip(after, before)) == (
        2 * per(n_g) + d_launches, 2 * (n_g + 3 * n_d), 0)
    for c, d in tr.state.d_params.items():
        assert not all(map(torch.equal, leaves(d), d0[c]))


@pytest.mark.gpu
def test_olmoe_train_step_goes_through_the_kernel_on_gpu(cuda_fp32):
    """One AdamW train step of the tiny OLMoE configuration on the card
    (clip 1.0 and decay 0.1 as the benchmark's file sets them): every
    leaf through the kernels, 3 launches (norm, scale, update)."""
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.runtime import make_train_step

    cfg = reduce_for_smoke(get_config("olmoe-1b-7b", "train_4k"), seq_len=32,
                           batch=4).override(
        {"optim.name": "adamw", "optim.lr": 1e-3, "optim.grad_clip": 1.0,
         "optim.weight_decay": 0.1, "parallel.microbatches": 2})
    m = cfg.model
    batch = {k: torch.as_tensor(v, device=cuda_fp32) for k, v in
             synthetic_lm_batch(4, 32, m.vocab_size, seed=3).items()}
    params = T.lm_init(0, m, torch.float32, cuda_fp32)
    opt_state = make_optimizer(cfg.optim).init(params)
    before = _counts()
    new_p, new_o, _ = make_train_step(cfg)(params, opt_state, batch, 0)
    after = _counts()
    n = len(leaves(params))
    assert (after[0] - before[0], after[1] - before[1],
            after[2] - before[2]) == (3, n, 0)
    assert not any(map(torch.equal, leaves(new_p), leaves(params)))
    assert int(new_o["step"]) == 1
