"""The port's fedavg op held against the JAX package, and its CUDA kernel
held against the plain version.

On the CPU the port's ``fedavg_flat`` / ``fedavg_trees`` take the plain
version (``ref.py``); they must match the JAX Pallas kernel run in
interpret mode and the host ``core.fedavg.fedavg`` to 1e-6 (relative and
absolute) — one fp32 weighted sum over up to 37 clients of values near 1,
summed in another order, a few fp32 ulp apart.  The host table builder
(``kernel.build_tables``) is a pure function and is tested here.  The CUDA
kernel itself runs only on a GPU: its tests carry the ``gpu`` marker and
skip here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import cuda, one_thread  # noqa: F401

from repro.core.fedavg import fedavg as jfedavg
from repro.kernels.fedavg.ops import fedavg_flat as jfedavg_flat
from repro.kernels.fedavg.ops import fedavg_trees as jfedavg_trees
from repro.models import dcgan as jdcgan
from repro.config import DCGANConfig as JDCGANConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.core.fedavg import fedavg
from repro_torch.kernels import build
from repro.fed.hierarchy import HierarchicalAggregator as JHierarchical
from repro_torch.fed.hierarchy import HierarchicalAggregator
from repro_torch.fed.policies import ClientUpdate, SyncFedAvg
from repro_torch.fed.programs import fedavg_stacked, stack_trees
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg.kernel import (BLOCK_ELEMS, MAX_CLIENTS,
                                               MAX_ENTRIES, MAX_LEAVES,
                                               build_tables, fedavg_kernel,
                                               fedavg_leaves_kernel)
from repro_torch.kernels.fedavg.ops import (fedavg_flat, fedavg_leaves,
                                            fedavg_trees)
from repro_torch.kernels.fedavg.ref import fedavg_leaves_ref, fedavg_ref
from repro_torch.tree import leaves, unflatten_like

TOL = dict(rtol=1e-6, atol=1e-6)
CPU = torch.device("cpu")


def _stack(c, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, n)).astype(np.float32),
            rng.uniform(1.0, 100.0, c).astype(np.float32))


def _client_trees(c, seed):
    jc = JDCGANConfig(base_filters=8)
    return [jax.tree.map(np.asarray, jdcgan.disc_init(
        jax.random.PRNGKey(seed + i), jc)) for i in range(c)]


# ragged leaves: 1 element, off 4-element multiples, one of several blocks
RAGGED = {"a": {"b": (1,), "w": (17, 5)}, "c": (4097,), "d": (3, 4, 2)}


def _ragged_trees(c, seed):
    """``c`` client trees of the RAGGED shapes, values near 1 from a numpy
    seed."""
    rng = np.random.default_rng(seed)

    def tree(spec):
        if isinstance(spec, dict):
            return {k: tree(v) for k, v in spec.items()}
        return torch.tensor(rng.uniform(0.5, 1.5, spec).astype(np.float32))
    return [tree(RAGGED) for _ in range(c)]


def _jax_tree(t):
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)


def _fmaf_chain(w, rows):
    """One fmaf chain a column over the rows in row order, from 0, in fp32:
    the product and the sum in long double (exact for an fp32 product),
    rounded once to fp32."""
    acc = np.zeros(rows.shape[1], np.float32)
    for k, x in zip(w, rows):
        acc = (np.longdouble(k) * x.astype(np.longdouble)
               + acc.astype(np.longdouble)).astype(np.float32)
    return acc


@pytest.mark.parametrize("c", [1, 2, 5])
@pytest.mark.parametrize("n", [1, 7, 4096, 4097, 10001])
def test_fedavg_flat_matches_jax_kernel(c, n):
    x, w = _stack(c, n, seed=c * 100003 + n)
    want = jfedavg_flat(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = fedavg_flat(torch.tensor(x), torch.tensor(w))
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c", [1, 2, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_fedavg_trees_matches_jax(c, weighted):
    trees = _client_trees(c, seed=c)
    weights = [float(10 + 7 * i) for i in range(c)] if weighted else None
    got = fedavg_trees([params_from_numpy(t, CPU) for t in trees], weights)
    for want in (jfedavg_trees([jax.tree.map(jnp.asarray, t) for t in trees],
                               weights, interpret=True),
                 jfedavg([jax.tree.map(jnp.asarray, t) for t in trees],
                         weights)):
        for g, w in zip(leaves(got), jax.tree.leaves(want)):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("c", [1, 2, 5])
def test_host_fedavg_matches_jax(c):
    trees = _client_trees(c, seed=10 + c)
    weights = [float(3 + i) for i in range(c)]
    got = fedavg([params_from_numpy(t, CPU) for t in trees], weights)
    want = jfedavg([jax.tree.map(jnp.asarray, t) for t in trees], weights)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_fedavg_rejects_zero_clients():
    with pytest.raises(ValueError):
        fedavg_trees([])
    with pytest.raises(ValueError):
        fedavg([])


def test_cpu_tensors_take_the_plain_version_not_the_kernel():
    before = fedavg_leaves_kernel.launches
    x, w = _stack(3, 100, seed=1)
    fedavg_flat(torch.tensor(x), torch.tensor(w))
    fedavg_trees(_ragged_trees(3, seed=1))
    assert fedavg_leaves_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fedavg_kernel(torch.tensor(x), torch.tensor(w))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["fedavg"])


def test_library_path_follows_the_source(monkeypatch, tmp_path):
    a = build.library_path("fedavg")
    assert a.parent == build.BUILD_DIR and a.suffix == ".so"
    assert build.library_path("fedavg") == a
    src = tmp_path / "fedavg.cu"
    src.write_text((build.CSRC / "fedavg.cu").read_text() + "\n// edited\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path("fedavg") != a


@pytest.mark.parametrize("c", [1, 5, 21, 37])
@pytest.mark.parametrize("weighted", [False, True])
def test_fedavg_trees_ragged_matches_jax(c, weighted):
    trees = _ragged_trees(c, seed=1000 + c)
    weights = ([float(1 + (7 * i) % 11) for i in range(c)] if weighted
               else None)
    got = fedavg_trees(trees, weights)
    want = jfedavg_trees([_jax_tree(t) for t in trees], weights,
                         interpret=True)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("c", [1, 5, 21])
def test_fedavg_trees_equals_the_stacked_form_bit_for_bit(c):
    """The plain round (one fedavg_leaves call) against the form it
    replaced: a stack a leaf and fedavg_flat, the weights normalised once
    by each."""
    trees = _ragged_trees(c, seed=c)
    weights = [float(2 + i) for i in range(c)]
    wt = torch.tensor(weights, dtype=torch.float32)
    got = fedavg_trees(trees, weights)
    for g, ls in zip(leaves(got), zip(*(leaves(t) for t in trees))):
        want = fedavg_flat(torch.stack([l.reshape(-1) for l in ls]), wt)
        assert torch.equal(g, want.reshape(ls[0].shape))


@pytest.mark.parametrize("cohorts", [2, 3])
def test_hierarchy_decode_kernel_reduce_matches_jax(cohorts):
    trees = _ragged_trees(7, seed=70 + cohorts)
    updates = {f"c{i}": (t, 1.0 + 0.5 * i) for i, t in enumerate(trees)}
    reds = HierarchicalAggregator(cohorts, use_kernel=True).reduce_all(updates)
    jreds = JHierarchical(cohorts, use_kernel=True, interpret=True
                          ).reduce_all({k: (_jax_tree(t), w)
                                        for k, (t, w) in updates.items()})
    assert len(reds) == len(jreds) == cohorts
    for r, jr in zip(reds, jreds):
        assert (r.cohort, r.weight, r.members) == (jr.cohort, jr.weight,
                                                   jr.members)
        for g, w in zip(leaves(r.aggregate), jax.tree.leaves(jr.aggregate)):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_hierarchy_kernel_reduce_equals_the_stacked_form_bit_for_bit():
    """The cohort pre-reduce reads the members' trees in place with the
    weights normalised twice: the bits of the stacked kernel form."""
    trees = _ragged_trees(4, seed=9)
    weights = [3.0, 1.0, 2.5, 0.5]
    red = HierarchicalAggregator(2, use_kernel=True).reduce_cohort(
        0, ["a", "b", "c", "d"], trees, weights)
    want = fedavg_stacked(stack_trees(trees), weights, use_kernel=True)
    assert red.weight == 7.0 and red.members == ("a", "b", "c", "d")
    for g, w in zip(leaves(red.aggregate), leaves(want)):
        assert torch.equal(g, w)


def test_fedavg_stacked_kernel_form_reads_any_layout():
    trees = _ragged_trees(3, seed=4)
    weights = [1.0, 2.0, 4.0]
    stacked = stack_trees(trees)
    # the same values in a transposed (non-contiguous) stack of leaf "c"
    strided = dict(stacked, c=stacked["c"].t().contiguous().t())
    assert not strided["c"].is_contiguous()
    want = fedavg_stacked(stacked, weights)
    for form in (stacked, strided):
        got = fedavg_stacked(form, weights, use_kernel=True)
        for g, w in zip(leaves(got), leaves(want)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_fedavg_leaves_plain_version_is_the_leaf_by_leaf_ref():
    trees = _ragged_trees(5, seed=3)
    flats = [leaves(t) for t in trees]
    w = torch.tensor([0.1, 0.2, 0.3, 0.15, 0.25])
    got = fedavg_leaves(flats, w * 4.0)       # normalised inside
    for g, ls in zip(got, zip(*flats)):
        want = fedavg_ref(torch.stack([l.reshape(-1) for l in ls]),
                          w * 4.0 / torch.sum(w * 4.0))
        assert torch.equal(g, want.reshape(ls[0].shape))
    assert [g.shape for g in fedavg_leaves_ref(flats, w)] == \
        [l.shape for l in flats[0]]


def test_round_end_and_cohort_reduce_make_one_leaves_call(monkeypatch):
    calls = []
    real = fedavg_ops.fedavg_leaves

    def counting(params_by_client, *args, **kwargs):
        calls.append((len(params_by_client), len(params_by_client[0])))
        return real(params_by_client, *args, **kwargs)

    monkeypatch.setattr(fedavg_ops, "fedavg_leaves", counting)
    trees = _ragged_trees(5, seed=5)
    policy = SyncFedAvg(use_kernel=True)
    for i, t in enumerate(trees):
        policy.on_update(None, ClientUpdate(f"c{i}", t, 1.0 + i))
    policy.on_round_end(None)
    assert calls == [(5, 4)]             # 5 clients x 4 leaves, one call
    hier = HierarchicalAggregator(2, use_kernel=True)
    hier.reduce_all({f"c{i}": (t, 1.0) for i, t in enumerate(trees)})
    assert calls == [(5, 4), (3, 4), (2, 4)]     # one call a cohort


def _fake_round(sizes, n_clients, off=None):
    """Leaf-major parameter addresses and output addresses, 16-byte
    aligned, each (leaf, client) in its own range; ``off`` = ("x", leaf,
    client) or ("out", leaf) moves that one address 4 bytes (one fp32
    element) off alignment."""
    x = [(1 << 40) + (l << 28) + (c << 20) for l in range(len(sizes))
         for c in range(n_clients)]
    out = [(1 << 41) + (l << 28) for l in range(len(sizes))]
    if off is not None and off[0] == "x":
        x[off[1] * n_clients + off[2]] += 4
    elif off is not None:
        out[off[1]] += 4
    return x, out


def _decode(table, launch):
    offset, n, nc, c0 = launch
    w = list(table[offset:offset + n * nc + 3 * n + 2])
    xs, rest = w[:n * nc], w[n * nc:]
    return xs, rest[:n], rest[n:2 * n], rest[2 * n:3 * n + 1], rest[-1]


@pytest.mark.parametrize("sizes,n_clients", [
    ([16, 1, 4, 16, 9216, 16384, 819200, 25600, 64, 128, 1024, 160], 5),
    ([1, 0, 4097, 1024, 1025, 0, 7], 21),
    ([2048, 1, 3, 5000], 37),
    ([3] * 40, 16),
    (list(range(70)), 3),
    ([5], 1)])
def test_build_tables_cover_every_element_once_in_client_order(sizes,
                                                               n_clients):
    x_ptrs, out_ptrs = _fake_round(sizes, n_clients)
    table, launches = build_tables(x_ptrs, out_ptrs, sizes, n_clients)
    live = [l for l, n in enumerate(sizes) if n > 0]
    per = min(MAX_LEAVES, MAX_ENTRIES // min(n_clients, MAX_CLIENTS))
    assert len(launches) == -(-n_clients // MAX_CLIENTS) * -(-len(live)
                                                             // per)
    pairs = []                        # (leaf, client) in launch order
    for launch in launches:
        xs, outs, ns, first, vec = _decode(table, launch)
        _, n, nc, c0 = launch
        assert 1 <= n <= MAX_LEAVES and 1 <= nc <= MAX_CLIENTS
        assert n * nc <= MAX_ENTRIES and c0 % MAX_CLIENTS == 0
        assert first[0] == 0
        owner = np.full(first[-1], -1)
        for j, o in enumerate(outs):
            leaf = out_ptrs.index(o)
            assert ns[j] == sizes[leaf] > 0
            assert np.all(owner[first[j]:first[j + 1]] == -1)
            owner[first[j]:first[j + 1]] = j
            # each element of the leaf in exactly one block, and no block
            # of the leaf without an element
            blocks = first[j] + np.arange(ns[j]) // BLOCK_ELEMS
            assert np.all(owner[blocks] == j)
            assert set(blocks.tolist()) == set(range(first[j], first[j + 1]))
            assert vec >> j & 1 == (ns[j] % 4 == 0)
            for k in range(nc):
                assert xs[j * nc + k] == x_ptrs[leaf * n_clients + c0 + k]
                pairs.append((leaf, c0 + k))
        assert np.all(owner >= 0) and vec >> n == 0
    assert sorted(pairs) == [(l, c) for l in live for c in range(n_clients)]
    for leaf in live:           # each leaf's clients come in client order
        assert [c for l, c in pairs if l == leaf] == list(range(n_clients))


@pytest.mark.parametrize("off", [None, ("x", 0, 0), ("x", 0, 4),
                                 ("x", 3, 2), ("out", 0), ("out", 3)])
def test_build_tables_clear_the_vector_bit_one_element_off(off):
    sizes = [8, 1024, 9, 4096]           # leaf 2: N not a multiple of 4
    x_ptrs, out_ptrs = _fake_round(sizes, 5, off)
    table, launches = build_tables(x_ptrs, out_ptrs, sizes, 5)
    assert len(launches) == 1
    vec = _decode(table, launches[0])[-1]
    want = {0, 1, 3} - ({off[1]} if off else set())
    assert {j for j in range(4) if vec >> j & 1} == want


def test_build_tables_of_empty_leaves_launch_nothing():
    table, launches = build_tables([64, 128], [256], [0], 2)
    assert launches == [] and len(table) == 0


# ---------------------------------------------------------------------------
# the CUDA kernel (GPU only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 2, 5])
@pytest.mark.parametrize("n", [1, 7, 4096, 4097, 819200, 1030913])
def test_kernel_matches_plain_version_on_gpu(cuda, c, n):
    x, w = _stack(c, n, seed=n + c)
    xs, ws = torch.tensor(x, device=cuda), torch.tensor(w / w.sum(),
                                                        device=cuda)
    before = fedavg_leaves_kernel.launches
    got = fedavg_kernel(xs, ws)
    torch.cuda.synchronize()
    assert fedavg_leaves_kernel.launches == before + 1
    torch.testing.assert_close(got, fedavg_ref(xs, ws), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.ones((3, 8), device=cuda)
    w = torch.full((3,), 1 / 3, device=cuda)
    with pytest.raises(TypeError):
        fedavg_kernel(x.double(), w)
    with pytest.raises(ValueError):
        fedavg_kernel(x.t(), torch.full((8,), 0.125, device=cuda))
    with pytest.raises(ValueError):
        fedavg_kernel(x, w[:2])
    with pytest.raises(ValueError):
        fedavg_kernel(x[:, :0].contiguous(), w)


def _round_on(dev, sizes, c, seed, view=False):
    """``c`` clients' fp32 leaves of ``sizes`` on ``dev`` from a numpy seed
    (each leaf one element into its buffer with ``view``), and normalised
    weights."""
    rng = np.random.default_rng(seed)

    def leaf(n):
        x = torch.tensor(rng.standard_normal(n).astype(np.float32),
                         device=dev)
        if not view:
            return x
        buf = torch.empty((n + 1,), device=dev)
        buf[1:] = x
        return buf[1:]
    params = [[leaf(n) for n in sizes] for _ in range(c)]
    w = torch.tensor(rng.uniform(0.5, 2.0, c).astype(np.float32), device=dev)
    return params, w / w.sum()


@pytest.mark.gpu
@pytest.mark.parametrize("c", [5, 21, 37])
def test_table_kernel_is_the_one_leaf_form_and_one_fmaf_chain(cuda, c):
    sizes = [1, 4097, 5000, 1600, 64, 819200]
    params, w = _round_on(cuda, sizes, c, seed=c)
    outs = [torch.empty((n,), device=cuda) for n in sizes]
    before = fedavg_leaves_kernel.launches
    got = fedavg_leaves_kernel(outs, params, w)
    torch.cuda.synchronize()
    assert fedavg_leaves_kernel.launches == before + -(-c // MAX_CLIENTS)
    for k, g in enumerate(got):
        rows = torch.stack([p[k] for p in params])
        assert g is outs[k]
        assert torch.equal(g, fedavg_kernel(rows, w))
        assert np.array_equal(g.cpu().numpy(), _fmaf_chain(
            w.cpu().numpy(), rows.cpu().numpy()))
        torch.testing.assert_close(g, fedavg_ref(rows, w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.gpu
def test_table_kernel_takes_views_single_and_empty_leaves(cuda):
    sizes = [1, 0, 4096, 7, 0, 1030]
    for view in (False, True):
        params, w = _round_on(cuda, sizes, 5, seed=11, view=view)
        outs = [torch.full((n,), 7.0, device=cuda) for n in sizes]
        if view:
            outs = [torch.empty((n + 1,), device=cuda)[1:] for n in sizes]
        got = fedavg_leaves_kernel(outs, params, w)
        want = fedavg_leaves_ref(params, w)
        torch.cuda.synchronize()
        for g, wl, n in zip(got, want, sizes):
            assert g.numel() == n
            torch.testing.assert_close(g, wl, rtol=1e-5, atol=1e-6)
    before = fedavg_leaves_kernel.launches
    fedavg_leaves_kernel([torch.empty((0,), device=cuda)],
                         [[torch.empty((0,), device=cuda)]] * 2,
                         torch.full((2,), 0.5, device=cuda))
    assert fedavg_leaves_kernel.launches == before


@pytest.mark.gpu
def test_table_kernel_rejects_what_it_does_not_take(cuda):
    params, w = _round_on(cuda, [8, 3], 3, seed=1)
    outs = [torch.empty((8,), device=cuda), torch.empty((3,), device=cuda)]
    with pytest.raises(TypeError):
        fedavg_leaves_kernel(outs, [[p.double() for p in ps]
                                    for ps in params], w)
    with pytest.raises(TypeError):
        fedavg_leaves_kernel(outs, params, w.double())
    with pytest.raises(ValueError):
        fedavg_leaves_kernel(outs, [[p.cpu() for p in ps] for ps in params],
                             w)
    with pytest.raises(ValueError):
        fedavg_leaves_kernel([o.cpu() for o in outs], params, w)
    with pytest.raises(ValueError):
        fedavg_leaves_kernel(outs, params, w.cpu())
    strided = torch.empty((8, 2), device=cuda)[:, 0]
    with pytest.raises(ValueError):
        fedavg_leaves_kernel(outs, [[strided, ps[1]] for ps in params], w)
    with pytest.raises(ValueError):
        fedavg_leaves_kernel([outs[0], outs[0]], params, w)   # sizes
    with pytest.raises(ValueError):
        fedavg_leaves_kernel(outs, params[:2], w)             # clients


@pytest.mark.gpu
def test_gan_round_d_params_are_the_single_stack_chain(cuda, monkeypatch):
    """Two rounds of the kernel-aggregated GAN trainer, against the same
    trainer whose round-end average is the single-stack kernel's chain
    (one fmaf chain a column in client order, emulated on the host): every
    D leaf equal bit for bit.  Deterministic cuDNN, so both train their
    clients alike."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gan import FSLGANTrainer
    from repro_torch.data import partition_dirichlet, synthetic_mnist
    from repro_torch.fed import policies

    imgs, labels = synthetic_mnist(120, seed=0)
    parts = partition_dirichlet(imgs, labels, 3, alpha=0.5, seed=0)
    cfg = get_config("dcgan-mnist").override({
        "shape.global_batch": 8, "fsl.num_clients": 3,
        "model.dcgan.base_filters": 8, "fed.kernel_aggregation": True})

    def chain_trees(trees, weights=None):
        w = torch.tensor(weights, dtype=torch.float32, device=cuda)
        w = (w / torch.sum(w)).cpu().numpy()
        out = [torch.tensor(_fmaf_chain(w, torch.stack(
            [l.reshape(-1) for l in ls]).cpu().numpy()), device=cuda
                            ).reshape(ls[0].shape)
               for ls in zip(*(leaves(t) for t in trees))]
        return unflatten_like(trees[0], out)

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = []
    for emulate in (False, True):
        if emulate:
            monkeypatch.setattr(policies, "fedavg_trees", chain_trees)
        tr = FSLGANTrainer(cfg, parts, seed=0)
        before = fedavg_leaves_kernel.launches
        for _ in range(2):
            tr.train_epoch(batches_per_client=2)
        torch.cuda.synchronize()
        assert fedavg_leaves_kernel.launches - before == (0 if emulate else 2)
        runs.append(leaves(tr.state.d_params["c0"]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
