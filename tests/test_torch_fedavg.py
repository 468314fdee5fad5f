"""The port's fedavg op held against the JAX package, and its CUDA kernel
held against the plain version.

On the CPU the port's ``fedavg_flat`` / ``fedavg_trees`` take the plain
version (``ref.py``); they must match the JAX Pallas kernel run in
interpret mode and the host ``core.fedavg.fedavg`` to 1e-6 relative — one
fp32 weighted sum over C <= 5 clients, summed in another order.  The CUDA
kernel itself runs only on a GPU: its tests carry the ``gpu`` marker and
skip here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fedavg import fedavg as jfedavg
from repro.kernels.fedavg.ops import fedavg_flat as jfedavg_flat
from repro.kernels.fedavg.ops import fedavg_trees as jfedavg_trees
from repro.models import dcgan as jdcgan
from repro.config import DCGANConfig as JDCGANConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.core.fedavg import fedavg
from repro_torch.kernels import build
from repro_torch.kernels.fedavg.kernel import fedavg_kernel
from repro_torch.kernels.fedavg.ops import fedavg_flat, fedavg_trees
from repro_torch.kernels.fedavg.ref import fedavg_ref
from repro_torch.tree import leaves

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
    before = fedavg_kernel.launches
    x, w = _stack(3, 100, seed=1)
    fedavg_flat(torch.tensor(x), torch.tensor(w))
    assert fedavg_kernel.launches == before
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


# ---------------------------------------------------------------------------
# the CUDA kernel (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fedavg kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 2, 5])
@pytest.mark.parametrize("n", [1, 7, 4096, 4097, 819200, 1030913])
def test_kernel_matches_plain_version_on_gpu(cuda, c, n):
    x, w = _stack(c, n, seed=n + c)
    xs, ws = torch.tensor(x, device=cuda), torch.tensor(w / w.sum(),
                                                        device=cuda)
    before = fedavg_kernel.launches
    got = fedavg_kernel(xs, ws)
    torch.cuda.synchronize()
    assert fedavg_kernel.launches == before + 1
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
