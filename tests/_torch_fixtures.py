"""Fixtures shared by the port's tests (``tests/test_torch_*.py``).

Every port test module imports the fixtures it takes by name, as it
imports the ``_hyp`` shim: ``one_thread`` always (it is autouse), ``cuda``
or ``cuda_fp32`` where a test needs the card.
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module, the previous count restored
    after it.  The port's tests compute on small tensors, and the suite
    runs several worker processes on a few cores, where PyTorch's spinning
    thread pools (one thread a core by default) starve each other: with
    six processes on eight cores, a split round's bit-equality test took
    102 s with a thread a core and 8 s with one, two trainer decode cases
    255 s and 8 s; alone, one thread is no slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.fixture
def cuda(monkeypatch):
    """The card, with cuBLAS's TF32 off for the test and restored after
    it: the kernels' tests hold the card's float32 products to float32
    tolerances."""
    return _card(monkeypatch)


@pytest.fixture
def cuda_fp32(monkeypatch):
    """``cuda`` with TF32 off for cuDNN too, restored after the test: the
    dcgan configurations compute in float32, and the tests that take this
    fixture hold the card's convolutions against float32 results at
    float32 tolerances."""
    dev = _card(monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return dev
