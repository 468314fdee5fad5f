"""What every part of the benchmark shares: where its files are, how a cell
is resolved from ``BENCHMARK.json`` by name, seeds, the frozen copy of the
port's noise-key arithmetic, and the comparison that decides ``correct``.

Nothing here imports the port: the references import this module too.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# top-level module names no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file by its path (metric readers and references have dots
    and dashes in their names)."""
    name = "perfbench_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(BENCH_DIR)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def resolve_cell(name: str) -> Dict[str, Any]:
    """Everything one cell runs, found by name: its workload entry, its
    configuration and traffic files, its limits and the metrics it
    reports, end to end (``e2e``) and per layer (``layer``)."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or name in m["workloads"]]
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "e2e": mine(bench["end_to_end"]),
            "layer": mine(bench["per_layer"])}


def reader(metric: str):
    """The ``read(ctx)`` function of one metric's reader file."""
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py").read


def driver(name: str):
    return load_module(BENCH_DIR / "drivers" / f"{name}.py")


def generator(name: str):
    """The ``make`` function of the input generator a traffic file names
    (``inputs/<generator>.py``)."""
    return load_module(BENCH_DIR / "inputs" / f"{name}.py").make


def reference(config_name: str):
    return load_module(BENCH_DIR / "reference" / f"{config_name}.py")


class Marks:
    """Host-clock seconds of the parts of a set-up, in order: ``mark(name)``
    closes the part that began at the last mark."""

    def __init__(self):
        import time
        self._now = time.perf_counter
        self._last = self._now()
        self.parts: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        t = self._now()
        self.parts[name] = self.parts.get(name, 0.0) + t - self._last
        self._last = t


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------

def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed from the run's ``--seed`` and a tag path, so that
    weights, data and noise streams never share one."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), *map(int, tags)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# ---------------------------------------------------------------------------
# frozen copy of the port's noise keys (``repro_torch/keys.py``): a key is
# a path of ints; its stream is a torch.Generator on the drawing device
# seeded from ``np.random.SeedSequence([len(key), *key])``
# ---------------------------------------------------------------------------

KEY_DP_SGD, KEY_STAGE = 1, 3


def key_seed(key: Sequence[int]) -> int:
    ss = np.random.SeedSequence([len(key), *(int(k) for k in key)])
    return int(ss.generate_state(1, np.uint64)[0])


def key_normal(key: Sequence[int], shape, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(key_seed(key))
    return torch.randn(tuple(shape), generator=g, device=device,
                       dtype=torch.float32)


# ---------------------------------------------------------------------------
# parameter trees: nested dicts walked in sorted-key order
# ---------------------------------------------------------------------------

def named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out.extend(named_leaves(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def leaf_norms(tree, prefix: str = "", split_stacked: Sequence[str] = ()
               ) -> Dict[str, float]:
    """L2 norm of each leaf in fp32 (one host read for the whole tree).
    Leaves under a name in ``split_stacked`` carry a leading layer axis
    and count as one leaf a layer."""
    names, vals = [], []
    for name, leaf in named_leaves(tree, prefix):
        x = leaf.detach().to(torch.float32)
        if any(name.startswith(s) for s in split_stacked):
            for i in range(x.shape[0]):
                names.append(f"{name}[{i}]")
                vals.append(torch.linalg.vector_norm(x[i]))
        else:
            names.append(name)
            vals.append(torch.linalg.vector_norm(x))
    got = torch.stack(vals).cpu().tolist()
    return dict(zip(names, got))


# ---------------------------------------------------------------------------
# the comparison behind ``correct``
# ---------------------------------------------------------------------------

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: it is left out of the change
QUIET_GRAD_SHARE = 1e-3


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   include: Optional[Iterable[str]] = None) -> float:
    """The widest gap between the program's norm of a leaf and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    names = list(include) if include is not None else list(ref)
    if set(prog) != set(ref):
        return math.inf
    med = statistics.median(ref[n] for n in ref)
    worst = 0.0
    for n in names:
        p, r = prog[n], ref[n]
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        worst = max(worst, abs(p - r) / max(r, med, 1e-30))
    return worst


def loud_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= QUIET_GRAD_SHARE * med]


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref) or not prog:
        return math.inf
    worst = 0.0
    for p, r in zip(prog, ref):
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        worst = max(worst, abs(p - r) / max(abs(r), 1e-12))
    return worst


def readings(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The numbers a training cell can compare, from the program's and the
    reference's records of the first three steps: ``loss`` (each step's
    losses), ``loss1`` (the first step's first loss), ``grad1`` (the first
    gradient as the optimizer holds it, the gap of norms by the worst
    leaf), ``change3`` (each leaf's change after three steps, by the worst
    leaf; a leaf counts where the reference's gradient of it,
    ``grad_basis``, is not quiet) and, where a record holds the norm of
    the difference of the two first gradients, ``grad1_diff`` (by the
    worst leaf, against the reference's norm or the median leaf's) and
    ``grad1_diff_med`` (the median leaf's); for the FSL-GAN round
    ``loss_first``, each client's first D step's loss (at the initial
    weights), and, where the reference's record holds the norm of each
    leaf's difference to the program's G and averaged D after the first
    round, ``diff1`` (by the worst leaf that is not quiet, against the
    reference's change of that leaf in the round or the median leaf's)
    and ``diff1_med`` (the median such leaf's).  A cell's limits file
    names the ones it compares."""
    out = {
        "loss": loss_gap(prog["losses"], ref["losses"]),
        "loss1": loss_gap(prog["losses"][:1], ref["losses"][:1]),
        "grad1": worst_leaf_gap(prog["grad1"], ref["grad1"]),
        "change3": worst_leaf_gap(prog["change3"], ref["change3"],
                                  loud_leaves(ref["grad_basis"])),
    }
    if "first_losses" in ref:
        out["loss_first"] = loss_gap(prog["first_losses"],
                                     ref["first_losses"])
    diff = ref.get("grad1_diff") or prog.get("grad1_diff")
    if diff is not None:
        med = statistics.median(ref["grad1"].values())
        rel = [diff[n] / max(r, med, 1e-30) for n, r in ref["grad1"].items()]
        out["grad1_diff"] = max(rel)
        out["grad1_diff_med"] = statistics.median(rel)
    side = ref if "diff1" in ref else prog
    if "diff1" in side:
        change = side["change1"]
        med = statistics.median(change.values())
        loud = set(loud_leaves(ref["grad_basis"]))
        rel = [side["diff1"][n] / max(c, med, 1e-30)
               for n, c in change.items() if n in loud]
        out["diff1"] = max(rel) if rel else math.inf
        out["diff1_med"] = statistics.median(rel) if rel else math.inf
        if not all(map(math.isfinite, rel)):
            out["diff1"] = out["diff1_med"] = math.inf
    return out


def detail(prog: Dict[str, Any], ref: Dict[str, Any], top: int = 4
           ) -> Dict[str, Any]:
    """Where the readings come from: each step's loss gap, and the leaves
    with the widest gaps (name, program, reference)."""
    def leaves(key):
        med = statistics.median(ref[key].values())
        gaps = sorted(((abs(prog[key][n] - r) / max(r, med, 1e-30), n,
                        prog[key][n], r) for n, r in ref[key].items()
                       if n in prog[key]), reverse=True)
        return [[n, g, p, r] for g, n, p, r in gaps[:top]]
    out = {"loss_gaps": [abs(p - r) / max(abs(r), 1e-12) for p, r in
                         zip(prog["losses"], ref["losses"])],
           "losses": ref["losses"],
           "grad1": leaves("grad1"), "change3": leaves("change3")}
    diff = ref.get("grad1_diff") or prog.get("grad1_diff")
    if diff is not None:
        med = statistics.median(ref["grad1"].values())
        out["grad1_diff"] = sorted(
            ([n, diff[n] / max(r, med, 1e-30)]
             for n, r in ref["grad1"].items()), key=lambda x: -x[1])
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` and each number beside its limit."""
    checks = {k: {"value": float(values[k]), "limit": float(limits[k])}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def env_for_checkout() -> None:
    """Build and kernel caches inside the checkout, at fixed paths; no
    library may load JAX on its own."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
