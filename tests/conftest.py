import os
import sys

# make `import repro` work regardless of how pytest is invoked
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); the test "
        "skips itself where torch.cuda.is_available() is false")
