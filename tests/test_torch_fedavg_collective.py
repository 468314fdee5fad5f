"""The collective FedAvg forms (``core/fedavg.fedavg_collective``,
``fedavg_weighted_collective``) on 2 and 4 CPU ranks of a gloo process
group (one subprocess a rank), against the port's and the reference's host
``fedavg`` of all the ranks' trees, to 1e-6; ``_check_same_structure``
with the reference's message; and ``partition_iid`` against the
reference's.
"""
import importlib
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro.data import partition_iid as jpartition_iid
from repro_torch.data import partition_iid

jfedavg = importlib.import_module("repro.core.fedavg")
tfedavg = importlib.import_module("repro_torch.core.fedavg")

TOL = 1e-6
WEIGHTS = [3.0, 1.0, 0.5, 2.5]
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")

# one rank: its tree from in{rank}.npz (leaf "h" in bf16), both collective
# forms over the gloo group, the results to out{rank}.npz
WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core.fedavg import (fedavg_collective,
                                     fedavg_weighted_collective)
rank, world, port, out, weight = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4],
                                  float(sys.argv[5]))
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
try:
    z = np.load(f"{out}/in{rank}.npz")
    tree = {"w": torch.tensor(z["w"]),
            "b": {"x": torch.tensor(z["x"]),
                  "h": torch.tensor(z["h"]).to(torch.bfloat16)}}
    w0 = tree["w"].clone()
    res = {"avg": fedavg_collective(tree),
           "wavg": fedavg_weighted_collective(tree, weight)}
    assert torch.equal(w0, tree["w"])              # inputs not written
    assert res["avg"]["b"]["h"].dtype == torch.bfloat16
    np.savez(f"{out}/out{rank}.npz", **{
        f"{form}_{k}": v.float().numpy() for form, t in res.items()
        for k, v in (("w", t["w"]), ("x", t["b"]["x"]),
                     ("h", t["b"]["h"]))})
finally:
    dist.destroy_process_group()
"""


def _tree(rank: int):
    """Rank ``rank``'s client tree (numpy)."""
    rng = np.random.default_rng(100 + rank)
    return {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "b": {"x": rng.normal(size=(3,)).astype(np.float32),
                  "h": rng.normal(size=(4, 2)).astype(np.float32)}}


def _to_torch(tree):
    return {"w": torch.tensor(tree["w"]),
            "b": {"x": torch.tensor(tree["b"]["x"]),
                  "h": torch.tensor(tree["b"]["h"]).to(torch.bfloat16)}}


def _np(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v, np.float32)


def _flat(tree):
    return {"w": _np(tree["w"]), "x": _np(tree["b"]["x"]),
            "h": _np(tree["b"]["h"])}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_collective_fedavg_matches_host_fedavg(world, tmp_path):
    for r in range(world):
        t = _tree(r)
        np.savez(tmp_path / f"in{r}.npz", w=t["w"], x=t["b"]["x"],
                 h=t["b"]["h"])
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(port),
         str(tmp_path), str(WEIGHTS[r])], env=env) for r in range(world)]
    try:
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * world
    trees = [_to_torch(_tree(r)) for r in range(world)]
    jtrees = [jax.tree.map(jnp.asarray, _tree(r)) for r in range(world)]
    for t in jtrees:
        t["b"]["h"] = t["b"]["h"].astype(jnp.bfloat16)
    w = WEIGHTS[:world]
    want = {"avg": (_flat(tfedavg.fedavg(trees)),
                    _flat(jfedavg.fedavg(jtrees))),
            "wavg": (_flat(tfedavg.fedavg(trees, w)),
                     _flat(jfedavg.fedavg(jtrees, w)))}
    for r in range(world):
        got = np.load(tmp_path / f"out{r}.npz")
        for form, (port_want, ref_want) in want.items():
            for k in ("w", "x", "h"):
                # a bf16 leaf: within one bf16 ulp of its largest value
                tol = TOL if k != "h" else 2 ** -8 * np.abs(
                    port_want[k]).max()
                np.testing.assert_allclose(got[f"{form}_{k}"], port_want[k],
                                           rtol=0, atol=tol)
                np.testing.assert_allclose(got[f"{form}_{k}"], ref_want[k],
                                           rtol=0, atol=tol)


def test_structure_check_matches_reference():
    a = {"w": torch.zeros(2), "b": {"x": torch.zeros(1)}}
    bad = {"w": torch.zeros(2), "c": torch.zeros(1)}
    with pytest.raises(ValueError) as got:
        tfedavg.fedavg([a, a, bad])
    ja = {"w": jnp.zeros(2), "b": {"x": jnp.zeros(1)}}
    with pytest.raises(ValueError) as want:
        jfedavg.fedavg([ja, ja, {"w": jnp.zeros(2), "c": jnp.zeros(1)}])
    assert str(got.value) == str(want.value) == \
        "client tree 2 structure differs from client 0"
    tfedavg._check_same_structure([a, {"w": torch.ones(2),
                                       "b": {"x": torch.ones(1)}}])


@pytest.mark.parametrize("n,k,seed", [(100, 4, 0), (37, 5, 3), (8, 8, 1)])
def test_partition_iid_matches_reference(n, k, seed):
    """Twin of tests/test_data_checkpoint.py's IID test, and equal to the
    reference's parts element for element."""
    data = np.arange(n)
    got, want = partition_iid(data, k, seed=seed), jpartition_iid(
        data, k, seed=seed)
    assert list(got) == list(want) == [f"c{i}" for i in range(k)]
    for c in got:
        np.testing.assert_array_equal(got[c], want[c])
    np.testing.assert_array_equal(np.sort(np.concatenate(list(
        got.values()))), data)
