"""Fixtures of the benchmark's CPU tests: cells cut to a size a test run
holds (the same code paths, tiny widths), and the card check."""
import copy
import sys
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parent.parent
for p in (str(_ROOT / "src"), str(_ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); the test "
        "skips itself where torch.cuda.is_available() is false")


def _merge(base, over):
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v


def tiny_limits_path(name):
    from perfbench import common
    return common.BENCH_DIR / "limits" / f"{name}.tiny.json"


def tiny_cells():
    """The cells that have tiny limits (``limits/<cell>.tiny.json``): those
    the CPU tests run, each at the size its files' ``tiny`` blocks give."""
    from perfbench import common
    return [w["name"] for w in common.benchmark()["workloads"]
            if tiny_limits_path(w["name"]).exists()]


def shrink(spec):
    """A cell at a tiny size: the ``tiny`` blocks of its configuration and
    traffic files merged over them (every path of the traffic kept), and
    its tiny limits in place of the card's."""
    from perfbench import common
    spec = copy.deepcopy(spec)
    for part in ("config", "traffic"):
        _merge(spec[part], spec[part].get("tiny", {}))
    spec["limits"] = common.load_json(tiny_limits_path(spec["cell"]["name"]))
    return spec


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def small_cell():
    from perfbench import common
    return lambda name: shrink(common.resolve_cell(name))


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")
    return torch.device("cuda")
