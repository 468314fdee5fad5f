"""Fixtures shared by the port's GPU tests (``tests/test_torch_*.py``).

A test module takes one by importing it by name, as it imports the
``_hyp`` shim.
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture
def cuda_fp32(monkeypatch):
    """The card with TF32 off for cuDNN and cuBLAS, restored after the
    test: the dcgan configurations compute in float32, and the tests that
    take this fixture hold the card's convolutions against float32 results
    at float32 tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the boundary_fuse kernel has no CPU "
                    "mode")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")
