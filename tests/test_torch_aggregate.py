"""The port's compressed-domain server reduce held against the JAX package
on the CPU: the agg_fuse ops, ``fed/aggregate``, ``fed/hierarchy``, the
async policies and the cohort-aware noise keys.

Inputs are made with numpy from a seed and go through the JAX function and
the port's.  The JAX agg_fuse kernels run in interpret mode, as
``tests/test_agg_stream.py`` runs them; the port's ops take their plain
versions on CPU tensors.  Tolerance rtol 1e-5 / atol 1e-6 wherever sums are
taken in another order than XLA's.  The CUDA kernels run only on a GPU:
their tests carry the ``gpu`` marker and skip here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import cuda, one_thread  # noqa: F401

from repro.fed.aggregate import StreamingAggregator as JStreamingAggregator
from repro.fed.aggregate import batched_reduce as jbatched_reduce
from repro.fed.aggregate import codec_rel_error as jcodec_rel_error
from repro.fed.aggregate import decode_enc as jdecode_enc
from repro.fed.aggregate import fused_decode_apply as jfused_decode_apply
from repro.fed.hierarchy import HierarchicalAggregator as JHierarchical
from repro.fed.hierarchy import assign_cohorts as jassign_cohorts
from repro.fed.policies import ClientUpdate as JClientUpdate
from repro.fed.policies import FedAsync as JFedAsync
from repro.fed.policies import FedBuff as JFedBuff
from repro.kernels.agg_fuse.ops import dequant_acc_flat as jdequant_acc_flat
from repro.kernels.agg_fuse.ops import \
    dequant_reduce_flat as jdequant_reduce_flat
from repro.kernels.agg_fuse.ops import scatter_acc_flat as jscatter_acc_flat
from repro_torch import keys
from repro_torch.bridge import params_from_numpy
from repro_torch.core.fedavg import fedavg
from repro_torch.fed.aggregate import (StreamingAggregator, batched_reduce,
                                       codec_rel_error, decode_enc,
                                       fused_decode_apply)
from repro_torch.fed.hierarchy import HierarchicalAggregator, assign_cohorts
from repro_torch.fed.policies import ClientUpdate, FedAsync, FedBuff
from repro_torch.fed.programs import (ClientHyper, RoundExecutor,
                                      fedavg_stacked, stack_trees)
from repro_torch.fed.transport import make_codec, tree_rel_error
from repro_torch.fed import aggregate as agg_module
from repro_torch.config import DCGANConfig
from repro_torch.kernels.agg_fuse.kernel import (
    MAX_LEAVES, REDUCE_CLIENTS, dequant_acc_kernel, dequant_acc_leaves_kernel,
    dequant_reduce_kernel, dequant_reduce_leaves_kernel, scatter_acc_kernel,
    scatter_acc_leaves_kernel)
from repro_torch.kernels.agg_fuse.ops import (dequant_acc_flat,
                                              dequant_acc_leaves,
                                              dequant_reduce_flat,
                                              dequant_reduce_leaves,
                                              scatter_acc_flat,
                                              scatter_acc_leaves)
from repro_torch.models.dcgan import disc_init
from repro_torch.kernels.agg_fuse.ref import (dequant_acc_ref,
                                              dequant_reduce_ref,
                                              scatter_acc_ref)
from repro_torch.tree import leaves

TOL = dict(rtol=1e-5, atol=1e-6)
WIRES = ("int8", "fp16", "fp32")
CODECS = ("none", "fp16", "int8", "topk")
JAX_MODES = {"ref": dict(use_kernel=False),
             "pallas": dict(use_kernel=True, interpret=True)}


def _wires(rng, c, n, wire):
    """(C, N) numpy wire rows and (C,) scales for a wire dtype."""
    if wire == "int8":
        return (rng.integers(-127, 128, (c, n)).astype(np.int8),
                rng.uniform(1e-3, 1e-1, c).astype(np.float32))
    x = rng.standard_normal((c, n)).astype(np.float32)
    return (x.astype(np.float16) if wire == "fp16" else x,
            np.ones(c, np.float32))


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# the agg_fuse ops against the JAX refs and the interpret-mode kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jmode", sorted(JAX_MODES))
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n", [4096, 5000])
def test_dequant_reduce_matches_jax(n, wire, jmode):
    rng = np.random.default_rng(n)
    wires, scales = _wires(rng, 5, n, wire)
    weights = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    got = dequant_reduce_flat(torch.tensor(wires), torch.tensor(scales),
                              torch.tensor(weights))
    want = jdequant_reduce_flat(jnp.asarray(wires), jnp.asarray(scales),
                                jnp.asarray(weights), **JAX_MODES[jmode])
    assert got.shape == (n,) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("jmode", sorted(JAX_MODES))
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n", [4096, 5000])
def test_dequant_acc_matches_jax(n, wire, jmode):
    rng = np.random.default_rng(n + 1)
    wires, scales = _wires(rng, 1, n, wire)
    acc = rng.standard_normal(n).astype(np.float32)
    scale = float(scales[0])
    got = dequant_acc_flat(torch.tensor(acc), torch.tensor(wires[0]),
                           torch.tensor(scale) if wire == "int8" else 1.0,
                           1.7)
    want = jdequant_acc_flat(jnp.asarray(acc), jnp.asarray(wires[0]),
                             jnp.float32(scale), 1.7, **JAX_MODES[jmode])
    _close(got, want)


@pytest.mark.parametrize("jmode", sorted(JAX_MODES))
@pytest.mark.parametrize("n", [4096, 5000])
def test_scatter_acc_sums_colliding_indices_like_jax(n, jmode):
    rng = np.random.default_rng(n + 2)
    acc = rng.standard_normal(n).astype(np.float32)
    idx = np.concatenate([rng.integers(0, n, 300), [0, 1, 1, n - 1, n - 1,
                                                    n - 1]]).astype(np.int32)
    vals = rng.standard_normal(idx.size).astype(np.float32)
    got = scatter_acc_flat(torch.tensor(acc), torch.tensor(vals),
                           torch.tensor(idx), 2.0)
    want = jscatter_acc_flat(jnp.asarray(acc), jnp.asarray(vals),
                             jnp.asarray(idx), 2.0, **JAX_MODES[jmode])
    _close(got, want)
    # collisions SUM, as .at[idx].add does
    zero = scatter_acc_ref(torch.zeros(n), torch.tensor(vals),
                           torch.tensor(idx), 1.0)
    assert float(zero[n - 1]) == pytest.approx(
        float(vals[idx == n - 1].sum()), rel=1e-6)


def test_scatter_acc_drops_out_of_range_indices_like_the_pallas_kernel():
    n = 5000
    acc = np.zeros(n, np.float32)
    idx = np.asarray([-1, -n, 0, 7, n, n + 3, 7], np.int32)
    vals = np.arange(1.0, 8.0, dtype=np.float32)
    got = scatter_acc_flat(torch.tensor(acc), torch.tensor(vals),
                           torch.tensor(idx), 0.5)
    want = jscatter_acc_flat(jnp.asarray(acc), jnp.asarray(vals),
                             jnp.asarray(idx), 0.5, use_kernel=True,
                             interpret=True)
    _close(got, want)
    assert float(got[0]) == 1.5 and float(got[7]) == 0.5 * (4.0 + 7.0)
    assert float(got.abs().sum()) == pytest.approx(1.5 + 5.5)


def _leaf_table(seed, sizes, distinct=False):
    """Accumulators, values and int32 indices of one top-k fold over leaves
    of ``sizes``: K ragged (1 .. N / 8 + 1); unless ``distinct``, some
    indices collide and some fall outside [0, N)."""
    rng = np.random.default_rng(seed)
    accs, vals, idxs = [], [], []
    for n in sizes:
        k = int(rng.integers(1, n // 8 + 2))
        if distinct:
            idx = rng.permutation(n)[:k]
        else:
            idx = rng.integers(-2, n + 2, k)
            idx[: k // 3] = n // 2                # collisions
        accs.append(rng.standard_normal(n).astype(np.float32))
        vals.append(rng.standard_normal(k).astype(np.float32))
        idxs.append(idx.astype(np.int32))
    return accs, vals, idxs


@pytest.mark.parametrize("sizes", [(5000,), (1, 7, 4097, 33, 5000),
                                   tuple(range(1, 80, 9))])
def test_scatter_acc_leaves_matches_a_jax_loop_over_leaves(sizes):
    """The one-call fold over a table of leaves (ragged K, colliding and
    out-of-range indices) against JAX's scatter_acc_flat leaf by leaf
    through the Pallas kernel in interpret mode."""
    accs, vals, idxs = _leaf_table(len(sizes), sizes)
    got = scatter_acc_leaves([torch.tensor(a) for a in accs],
                             [torch.tensor(v) for v in vals],
                             [torch.tensor(i) for i in idxs], 1.3,
                             use_kernel=True)
    assert len(got) == len(sizes)
    for g, a, v, i in zip(got, accs, vals, idxs):
        _close(g, jscatter_acc_flat(jnp.asarray(a), jnp.asarray(v),
                                    jnp.asarray(i), 1.3, use_kernel=True,
                                    interpret=True))


def test_scatter_acc_leaves_plain_version_is_scatter_acc_leaf_by_leaf():
    accs, vals, idxs = _leaf_table(3, (9, 100, 4097))
    ta = [torch.tensor(a) for a in accs]
    got = scatter_acc_leaves(ta, [torch.tensor(v) for v in vals],
                             [torch.tensor(i) for i in idxs], 0.7)
    for g, a, v, i, t in zip(got, accs, vals, idxs, ta):
        assert torch.equal(g, scatter_acc_flat(torch.tensor(a),
                                               torch.tensor(v),
                                               torch.tensor(i), 0.7))
        assert torch.equal(t, torch.tensor(a))      # a new tensor
    assert scatter_acc_leaves([], [], [], 1.0) == []
    with pytest.raises(ValueError, match="accumulators"):
        scatter_acc_leaves(ta, [torch.tensor(vals[0])],
                           [torch.tensor(idxs[0])], 1.0)
    # CPU tensors take the plain version even with use_kernel; the kernel
    # itself refuses them
    before = scatter_acc_leaves_kernel.launches
    scatter_acc_leaves(ta, [torch.tensor(v) for v in vals],
                       [torch.tensor(i) for i in idxs], 0.7, use_kernel=True)
    assert scatter_acc_leaves_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        scatter_acc_leaves_kernel(ta, [torch.tensor(v) for v in vals],
                                  [torch.tensor(i) for i in idxs], 0.7)


def test_topk_fold_makes_one_leaves_call_per_fold(monkeypatch):
    calls = []
    real = agg_module.scatter_acc_leaves

    def counting(accs, *args, **kwargs):
        calls.append(len(accs))
        return real(accs, *args, **kwargs)

    monkeypatch.setattr(agg_module, "scatter_acc_leaves", counting)
    deltas = [_delta(s) for s in range(3)]
    agg = StreamingAggregator("topk")
    agg.init(params_from_numpy(deltas[0], "cpu"))
    for d in deltas:
        agg.fold(_encode("topk", d), 1.0)
    assert calls == [2, 2, 2]          # the tree's two leaves, once a fold


def _small_d_sizes():
    """The discriminator's 12 leaf sizes at base_filters 8."""
    return tuple(l.numel() for l in leaves(disc_init(
        torch.Generator().manual_seed(0), DCGANConfig(base_filters=8),
        "meta")))


LEAF_SIZES = {"ragged": (1, 7, 4097, 33, 5000), "small_d": _small_d_sizes()}


def _client_wires(rng, sizes, c, wire):
    """Per leaf: C clients' wires (numpy) and their scales."""
    return [_wires(rng, c, n, wire) for n in sizes]


@pytest.mark.parametrize("jmode", sorted(JAX_MODES))
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("sizes", sorted(LEAF_SIZES))
def test_dequant_acc_leaves_matches_jax_leaf_by_leaf(sizes, wire, jmode):
    """A whole fold's table (one call) against JAX's dequant_acc_flat leaf
    by leaf; the port's op takes its plain version on CPU tensors even
    with use_kernel."""
    rng = np.random.default_rng(len(sizes))
    per_leaf = _client_wires(rng, LEAF_SIZES[sizes], 1, wire)
    accs = [rng.standard_normal(x.shape[1]).astype(np.float32)
            for x, _ in per_leaf]
    scales = ([torch.tensor(float(s[0])) for _, s in per_leaf]
              if wire == "int8" else None)
    got = dequant_acc_leaves([torch.tensor(a) for a in accs],
                             [torch.tensor(x[0]) for x, _ in per_leaf],
                             scales, 1.7, use_kernel=True)
    assert len(got) == len(accs)
    for g, a, (x, s) in zip(got, accs, per_leaf):
        want = jdequant_acc_flat(jnp.asarray(a), jnp.asarray(x[0]),
                                 jnp.float32(s[0]), 1.7, **JAX_MODES[jmode])
        assert g.shape == a.shape and g.dtype == torch.float32
        _close(g, want)


@pytest.mark.parametrize("jmode", sorted(JAX_MODES))
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("sizes", sorted(LEAF_SIZES))
def test_dequant_reduce_leaves_matches_jax_on_stacked_wires(sizes, wire,
                                                            jmode):
    """A whole round's reduce over unstacked client wires (one call)
    against JAX's dequant_reduce_flat on each leaf's (C, N) stack."""
    rng = np.random.default_rng(len(sizes) + 1)
    per_leaf = _client_wires(rng, LEAF_SIZES[sizes], 5, wire)
    weights = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    got = dequant_reduce_leaves(
        [[torch.tensor(row) for row in x] for x, _ in per_leaf],
        [[torch.tensor(v) for v in s] for _, s in per_leaf]
        if wire == "int8" else None, torch.tensor(weights), use_kernel=True)
    assert len(got) == len(per_leaf)
    for g, (x, s) in zip(got, per_leaf):
        want = jdequant_reduce_flat(jnp.asarray(x), jnp.asarray(s),
                                    jnp.asarray(weights), **JAX_MODES[jmode])
        assert g.shape == (x.shape[1],) and g.dtype == torch.float32
        _close(g, want)


def test_leaves_ops_return_new_tensors_and_stay_plain_on_the_cpu():
    """On CPU tensors the table ops take the plain version even with
    use_kernel (no launch counted) and return new tensors; the table
    kernels themselves refuse CPU tensors."""
    rng = np.random.default_rng(9)
    per_leaf = _client_wires(rng, (9, 100, 4097), 3, "int8")
    accs = [torch.zeros(x.shape[1]) for x, _ in per_leaf]
    wires = [[torch.tensor(row) for row in x] for x, _ in per_leaf]
    scales = [[torch.tensor(v) for v in s] for _, s in per_leaf]
    w = torch.tensor([1.0, 2.0, 0.5])
    acc_before = dequant_acc_leaves_kernel.launches
    red_before = dequant_reduce_leaves_kernel.launches
    got = dequant_acc_leaves(accs, [ws[0] for ws in wires],
                             [sc[0] for sc in scales], 0.7, use_kernel=True)
    for g, a, ws, sc in zip(got, accs, wires, scales):
        assert g is not a and torch.equal(a, torch.zeros_like(a))
        assert torch.equal(g, dequant_acc_flat(a, ws[0], sc[0], 0.7))
    means = dequant_reduce_leaves(wires, scales, w, use_kernel=True)
    for m, ws, sc in zip(means, wires, scales):
        assert torch.equal(m, dequant_reduce_flat(torch.stack(ws),
                                                  torch.stack(sc), w))
    assert dequant_acc_leaves_kernel.launches == acc_before
    assert dequant_reduce_leaves_kernel.launches == red_before
    assert dequant_acc_leaves([], [], None, 1.0) == []
    assert dequant_reduce_leaves([], None, w) == []
    with pytest.raises(ValueError, match="accumulators"):
        dequant_acc_leaves(accs, [wires[0][0]], None, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        dequant_acc_leaves_kernel(accs, [ws[0] for ws in wires], 0.7,
                                  [sc[0] for sc in scales])
    with pytest.raises(ValueError, match="CUDA"):
        dequant_reduce_leaves_kernel([torch.empty(x.shape[1])
                                      for x, _ in per_leaf], wires, w / 3.5,
                                     scales)
    with pytest.raises(ValueError, match="CUDA"):
        dequant_acc_kernel(accs[0], wires[0][0], 0.7, scales[0][0])
    with pytest.raises(ValueError, match="CUDA"):
        dequant_reduce_kernel(torch.stack(wires[0]),
                              torch.stack([w, torch.stack(scales[0])], 1))


@pytest.mark.parametrize("codec_name", ["none", "fp16", "int8"])
def test_dense_fold_makes_one_leaves_call_per_fold(codec_name, monkeypatch):
    calls = []
    real = agg_module.dequant_acc_leaves

    def counting(accs, *args, **kwargs):
        calls.append(len(accs))
        return real(accs, *args, **kwargs)

    monkeypatch.setattr(agg_module, "dequant_acc_leaves", counting)
    deltas = [_delta(s) for s in range(3)]
    agg = StreamingAggregator(codec_name)
    agg.init(params_from_numpy(deltas[0], "cpu"))
    for d in deltas:
        agg.fold(_encode(codec_name, d), 1.0)
    assert calls == [2, 2, 2]          # the tree's two leaves, once a fold


@pytest.mark.parametrize("codec_name", ["none", "fp16", "int8"])
def test_batched_reduce_makes_one_leaves_call_per_round(codec_name,
                                                        monkeypatch):
    calls = []
    real = agg_module.dequant_reduce_leaves

    def counting(wires_by_leaf, *args, **kwargs):
        calls.append([len(ws) for ws in wires_by_leaf])
        return real(wires_by_leaf, *args, **kwargs)

    monkeypatch.setattr(agg_module, "dequant_reduce_leaves", counting)
    deltas = [_delta(s) for s in range(4)]
    batched_reduce(codec_name, [_encode(codec_name, d) for d in deltas],
                   [1.0, 2.0, 0.5, 1.5], params_from_numpy(deltas[0], "cpu"))
    assert calls == [[4, 4]]     # once a round: 2 leaves x 4 client wires


def test_ops_return_new_tensors_on_the_cpu():
    acc = torch.zeros(8)
    out = dequant_acc_flat(acc, torch.ones(8, dtype=torch.int8),
                           torch.tensor(0.5), 2.0)
    assert torch.equal(out, torch.ones(8)) and torch.equal(acc,
                                                           torch.zeros(8))


def test_dequant_reduce_ref_is_weighted_mean():
    wires = torch.tensor([[2.0, 4.0], [6.0, 8.0]])
    out = dequant_reduce_flat(wires, torch.ones(2), torch.tensor([1.0, 3.0]))
    assert torch.allclose(out, torch.tensor([5.0, 7.0]))
    coefs = torch.tensor([[0.5, 1.0], [1.0, 1.0]])
    assert torch.allclose(dequant_reduce_ref(wires, coefs),
                          wires[0] * 0.5 + wires[1])


# ---------------------------------------------------------------------------
# fed/aggregate against decode-then-fedavg and against JAX
# ---------------------------------------------------------------------------

def _delta(seed):
    rng = np.random.default_rng(seed)
    return {"w": (0.1 * rng.standard_normal((33, 7))).astype(np.float32),
            "b": {"x": (0.1 * rng.standard_normal(11)).astype(np.float32)}}


def _encode(codec_name, delta_np):
    codec = make_codec(codec_name, topk_frac=0.25, error_feedback=False)
    return codec.encode_tree(params_from_numpy(delta_np, "cpu"))[0]


def _jenc(codec_name, enc):
    """The port's wire payload as the JAX package holds it."""
    out = []
    for wire, meta in enc:
        if codec_name == "topk":
            vals, idx = wire
            out.append(((jnp.asarray(vals.numpy()),
                         jnp.asarray(idx.numpy())), meta))
        elif codec_name == "int8":
            out.append((jnp.asarray(wire.numpy()), jnp.asarray(meta.numpy())))
        else:
            out.append((jnp.asarray(wire.numpy()), None))
    return out


def _close_trees(got, want, **tol):
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **(tol or TOL))


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("weighted", [False, True])
def test_streaming_fold_matches_decode_then_fedavg(codec_name, weighted):
    deltas = [_delta(s) for s in range(3)]
    weights = [1.0, 2.5, 0.5] if weighted else [1.0, 1.0, 1.0]
    encs = [_encode(codec_name, d) for d in deltas]
    template = params_from_numpy(deltas[0], "cpu")
    agg = StreamingAggregator(codec_name)
    agg.init(template)
    for enc, w in zip(encs, weights):
        assert agg.fold(enc, w) is None
    got = agg.finalize()
    decoded = [decode_enc(codec_name, enc, template) for enc in encs]
    want = fedavg_stacked(stack_trees(decoded), weights)
    for a, b in zip(leaves(got), leaves(want)):
        torch.testing.assert_close(a, b, **TOL)
    # and JAX's aggregator on the same wires
    jagg = JStreamingAggregator(codec_name, use_kernel=True, interpret=True)
    jagg.init(deltas[0])
    for enc, w in zip(encs, weights):
        jagg.fold(_jenc(codec_name, enc), w)
    _close_trees(got, jagg.finalize())


def test_finalize_before_any_fold_is_none():
    agg = StreamingAggregator("int8")
    assert agg.finalize() is None
    agg.init(params_from_numpy(_delta(0), "cpu"))
    assert agg.finalize() is None
    with pytest.raises(RuntimeError):
        StreamingAggregator("int8").fold([], 1.0)


@pytest.mark.parametrize("codec_name", CODECS)
def test_batched_reduce_matches_streaming_and_jax(codec_name):
    deltas = [_delta(10 + s) for s in range(4)]
    weights = [2.0, 1.0, 3.0, 0.5]
    encs = [_encode(codec_name, d) for d in deltas]
    template = params_from_numpy(deltas[0], "cpu")
    agg = StreamingAggregator(codec_name)
    agg.init(template)
    for enc, w in zip(encs, weights):
        agg.fold(enc, w)
    got_b = batched_reduce(codec_name, encs, weights, template)
    for a, b in zip(leaves(agg.finalize()), leaves(got_b)):
        torch.testing.assert_close(a, b, **TOL)
    want = jbatched_reduce(codec_name, [_jenc(codec_name, e) for e in encs],
                           weights, deltas[0], use_kernel=True,
                           interpret=True)
    _close_trees(got_b, want)


@pytest.mark.parametrize("codec_name", ["fp16", "int8", "topk"])
def test_fold_error_matches_densified_rel_error(codec_name):
    d = _delta(3)
    delta = params_from_numpy(d, "cpu")
    enc = _encode(codec_name, d)
    agg = StreamingAggregator(codec_name)
    agg.init(delta)
    err = agg.fold(enc, 1.0, delta=delta)
    want = tree_rel_error(decode_enc(codec_name, enc, delta), delta)
    assert err == pytest.approx(want, rel=1e-4, abs=1e-6)
    assert codec_rel_error(codec_name, enc, delta) == pytest.approx(
        err, rel=1e-6)
    ident = StreamingAggregator("none")
    ident.init(delta)
    assert ident.fold(_encode("none", d), 1.0, delta=delta) == 0.0


@pytest.mark.parametrize("codec_name", CODECS)
def test_decode_and_error_match_jax_on_identical_wires(codec_name):
    """Top-k ties select other entries in torch than in JAX (ROADMAP Queue
    A item 3), so both sides are fed the port's (vals, idx)."""
    d, base = _delta(5), _delta(6)
    delta = params_from_numpy(d, "cpu")
    tbase = params_from_numpy(base, "cpu")
    enc = _encode(codec_name, d)
    jenc = _jenc(codec_name, enc)
    _close_trees(decode_enc(codec_name, enc, delta),
                 jdecode_enc(codec_name, jenc, d), rtol=0, atol=0)
    _close_trees(fused_decode_apply(codec_name, tbase, enc),
                 jfused_decode_apply(codec_name, base, jenc), rtol=0, atol=0)
    assert codec_rel_error(codec_name, enc, delta) == pytest.approx(
        jcodec_rel_error(codec_name, jenc, d), rel=1e-5, abs=1e-7)


# ---------------------------------------------------------------------------
# fed/hierarchy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_clients", [1, 2, 3, 5, 7, 16])
@pytest.mark.parametrize("n_cohorts", [1, 2, 3, 4])
def test_assign_cohorts_matches_jax(n_clients, n_cohorts):
    ids = [f"c{i}" for i in range(n_clients)]
    assert assign_cohorts(ids, n_cohorts) == jassign_cohorts(ids, n_cohorts)
    by = lambda cid: int(cid[1:]) * 7 % 5          # noqa: E731
    assert assign_cohorts(ids, n_cohorts, by) == jassign_cohorts(
        ids, n_cohorts, by)


def _updates(n, codec_name=None):
    """Client id -> (tree or wire payload, weight), and the decoded trees."""
    out, trees = {}, {}
    for i in range(n):
        d = _delta(20 + i)
        w = 1.0 + i
        trees[f"c{i}"] = (params_from_numpy(d, "cpu"), w)
        if codec_name is not None:
            out[f"c{i}"] = (_encode(codec_name, d), w)
    return out, trees


@pytest.mark.parametrize("use_kernel", [False, True])
def test_reduce_all_equals_flat_fedavg(use_kernel):
    _, trees = _updates(5)
    hier = HierarchicalAggregator(2, use_kernel=use_kernel)
    reds = hier.reduce_all(trees)
    assert [r.members for r in reds] == [("c0", "c1", "c2"), ("c3", "c4")]
    assert [r.weight for r in reds] == [6.0, 9.0]
    got = fedavg([r.aggregate for r in reds], [r.weight for r in reds])
    want = fedavg([t for t, _ in trees.values()],
                  [w for _, w in trees.values()])
    for a, b in zip(leaves(got), leaves(want)):
        torch.testing.assert_close(a, b, **TOL)
    jreds = JHierarchical(2, use_kernel=use_kernel, interpret=True
                          ).reduce_all({k: (jax.tree.map(
                              lambda t: jnp.asarray(t.numpy()), v[0]), v[1])
                              for k, v in trees.items()})
    for r, jr in zip(reds, jreds):
        assert (r.cohort, r.weight, r.members) == (jr.cohort, jr.weight,
                                                   jr.members)
        _close_trees(r.aggregate, jr.aggregate)


@pytest.mark.parametrize("codec_name", CODECS)
def test_reduce_all_streaming_equals_flat_fedavg(codec_name):
    wires, trees = _updates(5, codec_name)
    template = trees["c0"][0]
    reds = HierarchicalAggregator(2).reduce_all_streaming(
        wires, template, codec_name=codec_name)
    assert [r.members for r in reds] == [("c0", "c1", "c2"), ("c3", "c4")]
    got = fedavg([r.aggregate for r in reds], [r.weight for r in reds])
    decoded = [decode_enc(codec_name, e, template) for e, _ in wires.values()]
    want = fedavg(decoded, [w for _, w in wires.values()])
    for a, b in zip(leaves(got), leaves(want)):
        torch.testing.assert_close(a, b, **TOL)


# ---------------------------------------------------------------------------
# the async policies
# ---------------------------------------------------------------------------

def _policy_inputs():
    g = _delta(30)
    ups = [(_delta(31 + i), 1.0 + i, s) for i, s in enumerate([0, 2, 1, 0,
                                                               3])]
    return g, ups


@pytest.mark.parametrize("policy", ["fedasync", "fedbuff"])
def test_async_policies_match_jax(policy):
    g, ups = _policy_inputs()
    if policy == "fedasync":
        ours, ref = FedAsync(0.6, 0.5), JFedAsync(0.6, 0.5)
        assert [ours.rate(s) for s in range(5)] == [ref.rate(s)
                                                    for s in range(5)]
    else:
        ours, ref = FedBuff(2, 0.8, 0.5), JFedBuff(2, 0.8, 0.5)
    tg, jg = params_from_numpy(g, "cpu"), jax.tree.map(jnp.asarray, g)
    for i, (p, w, s) in enumerate(ups):
        tg, bumped = ours.on_update(
            tg, ClientUpdate(f"c{i}", params_from_numpy(p, "cpu"), w, s))
        jg, jbumped = ref.on_update(
            jg, JClientUpdate(f"c{i}", jax.tree.map(jnp.asarray, p), w, s))
        assert bumped == jbumped
        _close_trees(tg, jg, rtol=1e-6, atol=1e-7)
    _close_trees(ours.on_round_end(tg), ref.on_round_end(jg), rtol=1e-6,
                 atol=1e-7)


def test_fedbuff_flushes_a_partial_buffer_at_round_end():
    g, ups = _policy_inputs()
    pol = FedBuff(buffer_size=10)
    tg = params_from_numpy(g, "cpu")
    p, w, s = ups[0]
    tg2, bumped = pol.on_update(tg, ClientUpdate("c0", params_from_numpy(
        p, "cpu"), w, s))
    assert not bumped and tg2 is tg
    out = pol.on_round_end(tg)
    for a, b in zip(leaves(out), leaves(params_from_numpy(p, "cpu"))):
        torch.testing.assert_close(a, b, **TOL)     # server_lr 1.0: replace
    assert pol.on_round_end(tg) is tg


# ---------------------------------------------------------------------------
# the cohort-aware noise key
# ---------------------------------------------------------------------------

def _executor(cohort_of=None, round_key=keys.root(keys.DP_SGD, 3)):
    cids = [f"c{i}" for i in range(5)]
    return RoundExecutor(None, backend="loop", sample=None, opt_lookup=None,
                         default_steps=1,
                         hyper={cid: ClientHyper() for cid in cids},
                         round_key=round_key, cohort_of=cohort_of), cids


def test_key_for_folds_the_cohort_and_stays_distinct():
    grouped = assign_cohorts([f"c{i}" for i in range(5)], 2)
    cmap = {cid: c for c, ms in grouped.items() for cid in ms}
    ex, cids = _executor(lambda cid: cmap[cid])
    ks = [ex._key_for(cid) for cid in cids]
    again, _ = _executor(lambda cid: cmap[cid])
    assert ks == [again._key_for(cid) for cid in cids]     # deterministic
    assert len(set(ks)) == len(ks)                         # distinct
    root = keys.root(keys.DP_SGD, 3)
    assert ks == [keys.fold_in(root, cmap[c], i, 0) for i, c in
                  enumerate(cids)]
    # a second execution of the same client gets the next index
    assert ex._key_for("c4") == keys.fold_in(root, 1, 4, 1)
    assert len({keys.seed_of(k) for k in ks}) == len(ks)


def test_key_for_without_hierarchy_keeps_cohort_zero():
    ex, cids = _executor()
    root = keys.root(keys.DP_SGD, 3)
    assert [ex._key_for(c) for c in cids] == [keys.fold_in(root, 0, i, 0)
                                              for i in range(5)]
    ex, cids = _executor(round_key=None)
    assert ex._key_for(cids[0]) is None


# ---------------------------------------------------------------------------
# the CUDA kernels (GPU only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n", [1, 4096, 4097, 5000, 819_200])
def test_dense_kernels_match_plain_versions_on_gpu(cuda, wire, n):
    rng = np.random.default_rng(n)
    wires, scales = _wires(rng, 5, n, wire)
    tw = torch.tensor(wires, device=cuda)
    coefs = torch.stack([torch.tensor(rng.uniform(0.1, 0.3, 5),
                                      dtype=torch.float32),
                         torch.tensor(scales)], dim=1).to(cuda)
    before = dequant_reduce_leaves_kernel.launches
    got = dequant_reduce_kernel(tw, coefs)
    again = dequant_reduce_kernel(tw, coefs)
    torch.cuda.synchronize()
    assert dequant_reduce_leaves_kernel.launches == before + 2
    torch.testing.assert_close(got, dequant_reduce_ref(tw, coefs), **TOL)
    assert torch.equal(got, again)
    acc = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                       device=cuda)
    scale = torch.tensor(scales[0], device=cuda) if wire == "int8" else None
    want = dequant_acc_ref(acc, tw[0], 0.3, 1.0 if scale is None else scale)
    out = dequant_acc_kernel(acc, tw[0], 0.3, scale)
    torch.cuda.synchronize()
    assert out is acc and torch.equal(out, want)


def scatter_sum_bound(acc, vals, idx, weight):
    """``(want, bound)`` for ``acc[idx] += weight * vals``: ``want`` the
    scatter on float64 copies, ``bound`` per element the worst-case error
    of a float32 result, to first order: ``k_i`` float32 products summed
    with ``acc_i`` in any order (``k_i`` the values that land on ``i``)
    err by at most ``(k_i + 1) * 2**-24 * (|acc_i| + sum |w v|)``.  The
    kernel's atomics add in launch order, so only a bound holds it where
    indices collide."""
    n = acc.shape[0]
    ok = (idx >= 0) & (idx < n)
    i = idx[ok].long()
    wv = float(weight) * vals[ok].double()
    want = acc.double().index_add(0, i, wv)
    k = torch.zeros_like(want).index_add(0, i, torch.ones_like(wv))
    mag = acc.double().abs().index_add(0, i, wv.abs())
    return want, (k + 1) * 2.0 ** -24 * mag


def _colliding_scatter(rng, dev, n, k):
    idx = torch.tensor(np.r_[rng.integers(0, 64, k), -1, n],
                       dtype=torch.int32, device=dev)
    vals = torch.tensor(rng.standard_normal(k + 2), dtype=torch.float32,
                        device=dev)
    return vals, idx


def _within_scatter_bound(scatter, acc, vals, idx, weight):
    """Whether ``scatter`` holds the bound on the colliding inputs, and
    whether it still does with the colliding value of largest magnitude
    dropped (it must not: the bound would not catch a wrong sum)."""
    want, bound = scatter_sum_bound(acc, vals, idx, weight)
    got = scatter(acc.clone(), vals, idx, weight)
    n = acc.shape[0]
    ok = (idx >= 0) & (idx < n)
    hits = torch.bincount(idx[ok].long(), minlength=n)
    colliding = ok & (hits[idx.clamp(0, n - 1).long()] > 1)
    j = int(torch.argmax(torch.where(colliding, vals.abs(), -1.0)))
    dropped = vals.clone()
    dropped[j] = 0.0
    bad = scatter(acc.clone(), dropped, idx, weight)
    return (bool(((got.double() - want).abs() <= bound).all()),
            bool(((bad.double() - want).abs() <= bound).all()))


def test_scatter_bound_holds_plain_fold_and_catches_a_dropped_summand():
    """The bound the GPU test holds the kernel to, on the plain version:
    8,192 values into 64 indices pass, one value dropped does not."""
    n, k = 819_200, 8192
    rng = np.random.default_rng(1)
    acc = torch.tensor(rng.standard_normal(n), dtype=torch.float32)
    vals, idx = _colliding_scatter(rng, "cpu", n, k)
    assert _within_scatter_bound(scatter_acc_ref, acc, vals, idx, 0.25) \
        == (True, False)


@pytest.mark.gpu
def test_scatter_kernel_matches_index_add_on_gpu(cuda):
    """Distinct indices: equal to ``index_add`` bit for bit.  Colliding
    indices (8,192 values into 64): within ``scatter_sum_bound`` of the
    float64 scatter, and the same inputs with one colliding value dropped
    outside it."""
    n, k = 819_200, 8192
    rng = np.random.default_rng(0)
    acc = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                       device=cuda)
    vals = torch.tensor(rng.standard_normal(k), dtype=torch.float32,
                        device=cuda)
    idx = torch.tensor(rng.permutation(n)[:k], dtype=torch.int32,
                       device=cuda)
    want = scatter_acc_ref(acc, vals, idx, 0.25)
    assert torch.equal(scatter_acc_kernel(acc.clone(), vals, idx, 0.25),
                       want)
    vals, idx = _colliding_scatter(rng, cuda, n, k)
    before = scatter_acc_leaves_kernel.launches
    held = _within_scatter_bound(scatter_acc_kernel, acc, vals, idx, 0.25)
    torch.cuda.synchronize()
    assert scatter_acc_leaves_kernel.launches == before + 2
    assert held == (True, False)


def _d_leaf_sizes():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.dcgan import disc_init
    return [l.numel() for l in leaves(disc_init(
        torch.Generator().manual_seed(0),
        get_config("dcgan-mnist").model.dcgan, "meta"))]


@pytest.mark.gpu
@pytest.mark.parametrize("n_leaves", [None, MAX_LEAVES + 6])
def test_scatter_table_matches_index_add_on_gpu(cuda, n_leaves):
    """One launch for the 12 D leaves of the main path (K = 1% of each,
    distinct indices: equal to index_add_ bit for bit), and two for a
    table one chunk longer than a launch takes."""
    sizes = _d_leaf_sizes()
    if n_leaves is not None:
        sizes = (sizes * 8)[:n_leaves]
    rng = np.random.default_rng(len(sizes))
    accs, vals, idxs = [], [], []
    for n in sizes:
        k = max(1, n // 100)
        accs.append(torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                                 device=cuda))
        vals.append(torch.tensor(rng.standard_normal(k), dtype=torch.float32,
                                 device=cuda))
        idxs.append(torch.tensor(rng.permutation(n)[:k], dtype=torch.int32,
                                 device=cuda))
    want = [a.clone().index_add_(0, i.long(), v, alpha=0.37)
            for a, v, i in zip(accs, vals, idxs)]
    plain = scatter_acc_leaves(accs, vals, idxs, 0.37)
    before = scatter_acc_leaves_kernel.launches
    got = scatter_acc_leaves(accs, vals, idxs, 0.37, use_kernel=True)
    torch.cuda.synchronize()
    assert scatter_acc_leaves_kernel.launches - before == -(-len(sizes)
                                                            // MAX_LEAVES)
    for g, a, w, p in zip(got, accs, want, plain):
        assert g is a and torch.equal(g, w) and torch.equal(g, p)


@pytest.mark.gpu
def test_scatter_table_sums_collisions_and_drops_out_of_range_on_gpu(cuda):
    accs, vals, idxs = _leaf_table(11, (1, 7, 4097, 33, 819_200))
    ta = [torch.tensor(a, device=cuda) for a in accs]
    tv = [torch.tensor(v, device=cuda) for v in vals]
    ti = [torch.tensor(i, device=cuda) for i in idxs]
    want = scatter_acc_leaves(ta, tv, ti, 0.6)
    got = scatter_acc_leaves([a.clone() for a in ta], tv, ti, 0.6,
                             use_kernel=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def _gpu_wires(rng, sizes, c, wire, dev, offset=0):
    """Per leaf: C client wires on ``dev`` (each a view ``offset`` elements
    into its own buffer) and their scales (None unless int8)."""
    wires, scales = [], []
    for n in sizes:
        x, s = _wires(rng, c, n + offset, wire)
        wires.append([torch.tensor(row, device=dev)[offset:] for row in x])
        scales.append([torch.tensor(v, device=dev) for v in s]
                      if wire == "int8" else None)
    return wires, (scales if wire == "int8" else None)


def _fmaf_chain(coefs, rows):
    """The reduce kernel's order of sums, emulated on the host: one fused
    multiply-add a client in client order, each exact in long double and
    rounded once to fp32."""
    acc = np.zeros(rows.shape[1], np.float32)
    for k, x in zip(coefs, rows):
        acc = (np.longdouble(k) * x.astype(np.longdouble)
               + acc.astype(np.longdouble)).astype(np.float32)
    return acc


@pytest.mark.gpu
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n_leaves", [None, MAX_LEAVES + 6])
def test_dequant_acc_table_matches_plain_bit_for_bit_on_gpu(cuda, wire,
                                                            n_leaves):
    """A fold over the 12 D leaves in one launch, and over a table one
    chunk longer than a launch takes in two, equal to the plain version
    bit for bit, in place."""
    sizes = _d_leaf_sizes()
    if n_leaves is not None:
        sizes = (sizes * 8)[:n_leaves]
    rng = np.random.default_rng(len(sizes))
    wires, scales = _gpu_wires(rng, sizes, 1, wire, cuda)
    wires = [ws[0] for ws in wires]
    scales = None if scales is None else [sc[0] for sc in scales]
    accs = [torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=cuda) for n in sizes]
    want = dequant_acc_leaves(accs, wires, scales, 0.3)
    before = dequant_acc_leaves_kernel.launches
    got = dequant_acc_leaves(accs, wires, scales, 0.3, use_kernel=True)
    torch.cuda.synchronize()
    assert dequant_acc_leaves_kernel.launches - before == -(-len(sizes)
                                                            // MAX_LEAVES)
    for g, a, w in zip(got, accs, want):
        assert g is a and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", WIRES)
def test_dequant_reduce_table_matches_plain_and_the_stacked_table_on_gpu(
        cuda, wire):
    """A round's reduce over the 12 D leaves and ragged ones, client wires
    read in place: one launch, at TOL of the plain version, the same bits
    on a second launch and as the one-leaf table over each leaf's stacked
    rows."""
    sizes = _d_leaf_sizes() + [1, 4097, 5000]
    rng = np.random.default_rng(7)
    wires, scales = _gpu_wires(rng, sizes, 5, wire, cuda)
    weights = torch.tensor(rng.uniform(0.5, 2.0, 5), dtype=torch.float32,
                           device=cuda)
    want = dequant_reduce_leaves(wires, scales, weights)
    before = dequant_reduce_leaves_kernel.launches
    got = dequant_reduce_leaves(wires, scales, weights, use_kernel=True)
    again = dequant_reduce_leaves(wires, scales, weights, use_kernel=True)
    torch.cuda.synchronize()
    assert dequant_reduce_leaves_kernel.launches - before == 2
    w = (weights / weights.sum()).to(torch.float32)
    for leaf, (g, a, p) in enumerate(zip(got, again, want)):
        torch.testing.assert_close(g, p, **TOL)
        assert torch.equal(g, a)
        sc = (torch.ones_like(w) if scales is None
              else torch.stack(scales[leaf]))
        stacked = dequant_reduce_kernel(torch.stack(wires[leaf]),
                                        torch.stack([w, sc], dim=1))
        assert torch.equal(g, stacked)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n_clients", [5, REDUCE_CLIENTS + 4,
                                       2 * REDUCE_CLIENTS + 5])
def test_dequant_reduce_chunks_clients_bit_for_bit_on_gpu(cuda, wire,
                                                          n_clients):
    """More clients than one launch takes go in chunks that continue the
    fmaf chain from out in client order: the result equals one chain over
    all clients (emulated on the host) bit for bit, as one launch's does
    at C = 5."""
    sizes = (1, 4097, 5000, 64)
    rng = np.random.default_rng(n_clients)
    wires, scales = _gpu_wires(rng, sizes, n_clients, wire, cuda)
    w = torch.tensor(rng.uniform(0.5, 2.0, n_clients),
                     dtype=torch.float32, device=cuda)
    w = (w / w.sum()).to(torch.float32)
    outs = [torch.empty((n,), device=cuda) for n in sizes]
    before = dequant_reduce_leaves_kernel.launches
    got = dequant_reduce_leaves_kernel(outs, wires, w, scales)
    torch.cuda.synchronize()
    assert dequant_reduce_leaves_kernel.launches - before == -(
        -n_clients // REDUCE_CLIENTS)
    for leaf, g in enumerate(got):
        sc = (torch.ones_like(w) if scales is None
              else torch.stack(scales[leaf]))
        coefs = (w * sc).cpu().numpy()
        rows = torch.stack(wires[leaf]).float().cpu().numpy()
        assert np.array_equal(g.cpu().numpy(), _fmaf_chain(coefs, rows))


@pytest.mark.gpu
@pytest.mark.parametrize("wire", WIRES)
def test_dense_tables_take_unaligned_views_one_element_and_zero_leaves_on_gpu(
        cuda, wire):
    """Wires, accumulators and outputs one element off a 4-element
    boundary take the scalar path beside aligned leaves of the same table;
    N = 1; an all-zero int8 leaf (scale 1.0) adds 0."""
    sizes = (1, 4096, 4097, 1600)
    rng = np.random.default_rng(3)
    wires, scales = _gpu_wires(rng, sizes, 5, wire, cuda, offset=1)
    weights = torch.tensor(rng.uniform(0.5, 2.0, 5), dtype=torch.float32,
                           device=cuda)
    w = (weights / weights.sum()).to(torch.float32)
    outs = [torch.empty((n + 1,), device=cuda)[1:] for n in sizes]
    got = dequant_reduce_leaves_kernel(outs, wires, w, scales)
    for g, p in zip(got, dequant_reduce_leaves(wires, scales, weights)):
        torch.testing.assert_close(g, p, **TOL)
    accs = [torch.tensor(rng.standard_normal(n + 1), dtype=torch.float32,
                         device=cuda)[1:] for n in sizes]
    one = [ws[0] for ws in wires]
    sc1 = None if scales is None else [s[0] for s in scales]
    want = dequant_acc_leaves(accs, one, sc1, 0.45)
    got = dequant_acc_leaves_kernel(accs, one, 0.45, sc1)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    zero = torch.zeros((4096,), dtype=torch.int8, device=cuda)
    one_scale = torch.ones((), device=cuda)
    acc = torch.randn((4096,), device=cuda)
    out = dequant_acc_leaves_kernel([acc.clone()], [zero], 0.3,
                                    [one_scale])[0]
    red = dequant_reduce_leaves_kernel(
        [torch.empty((4096,), device=cuda)], [[zero] * 5], w,
        [[one_scale] * 5])[0]
    torch.cuda.synchronize()
    assert torch.equal(out, acc) and torch.equal(red, torch.zeros_like(red))
