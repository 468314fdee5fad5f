"""The port's sharding rules, activation policy, N-axis meshes and roofline
records: twins of tests/test_sharding_roofline.py, and the collective
convention pinned on a hand-computed case.

Exact equalities throughout, except the roofline terms (ratios of counts
to the H100's peaks), which hold to 1e-12 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.roofline.analysis import RooflineReport as JReport
from repro.sharding import specs as jspecs
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import registry as treg
from repro_torch.launch.mesh import (Mesh, make_client_mesh, make_host_mesh,
                                     make_production_mesh, mesh_chips)
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import lm_init, lm_loss
from repro_torch.roofline.analysis import (RooflineReport, StepCounts,
                                           StepTrace, analyze_step,
                                           collective_bytes, kernel_terms,
                                           rank_bytes, shard_factor)
from repro_torch.roofline.hw import H100
from repro_torch.sharding.specs import (AxisRules, Lg, PartitionSpec as P,
                                        Sharding, constrain, default_rules,
                                        logical_spec, make_activation_policy,
                                        set_activation_policy, spec_for_param,
                                        tree_shardings)
from repro_torch.tree import ShapeDtype

REL = 1e-12


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


@pytest.fixture
def host():
    return make_host_mesh(device_type="cpu")


def test_logical_spec_divisibility(host):
    rules = default_rules(host)
    assert isinstance(logical_spec(host, rules, (16, 32), ("embed", "mlp")),
                      P)


def test_logical_spec_drops_nondivisible():
    rules = AxisRules(rules={"embed": "data", "mlp": "model",
                             "batch": ("pod", "data")})
    assert logical_spec(FakeMesh(), rules, (30, 64), ("embed", "mlp")) == \
        P(None, "model")


def test_logical_spec_no_axis_reuse():
    class Small:
        axis_names = ("data", "model")
        shape = {"data": 4, "model": 4}
    rules = AxisRules(rules={"embed": "data", "mlp": "data"})
    assert logical_spec(Small(), rules, (8, 8), ("embed", "mlp")) == \
        P("data")


def test_tree_shardings_structure_mismatch_raises(host):
    with pytest.raises((ValueError, KeyError)):
        tree_shardings(host, default_rules(host),
                       {"a": torch.ones((4, 4))}, {"b": Lg("embed", "mlp")})


@pytest.mark.parametrize("fsdp,tp,sp", [(True, True, True),
                                        (False, True, False),
                                        (True, False, True),
                                        (False, False, False)])
@pytest.mark.parametrize("multi", [False, True])
def test_default_rules_match_reference(multi, fsdp, tp, sp):
    cfg = jreg.get_config("qwen3-14b").override({
        "parallel.fsdp": fsdp, "parallel.tensor_parallel": tp,
        "parallel.sequence_parallel": sp})
    tm = make_production_mesh(multi_pod=multi)
    jm = AbstractMesh(tuple(tm.axis_sizes), tuple(tm.axis_names))
    tcfg = treg.get_config("qwen3-14b").override({
        "parallel.fsdp": fsdp, "parallel.tensor_parallel": tp,
        "parallel.sequence_parallel": sp})
    jr = jspecs.default_rules(jm, cfg.parallel)
    tr = default_rules(tm, tcfg.parallel)
    assert jr.rules == tr.rules
    assert (jr.fsdp, jr.tensor_parallel, jr.sequence_parallel) == \
        (tr.fsdp, tr.tensor_parallel, tr.sequence_parallel)
    for shape, lg in (((256, 4096), ("batch", "seq")),
                      ((1, 524288, 8, 128), ("batch", "seq", "kv", None)),
                      ((5120, 17408), ("embed", "mlp")),
                      ((60, 5120, 1408), ("experts", "embed", "mlp")),
                      ((30, 64), ("embed", "vocab"))):
        assert tuple(logical_spec(tm, tr, shape, lg)) == \
            tuple(jspecs.logical_spec(jm, jr, shape, lg))
        assert spec_for_param(tm, tr, shape, lg) == Sharding(
            tm, logical_spec(tm, tr, shape, lg))


def test_meshes():
    """N named axes; the production meshes are abstract; the 1-D client
    mesh is unchanged."""
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and not single.devices
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert (mesh_chips(single), mesh_chips(multi)) == (256, 512)
    host = make_host_mesh(device_type="cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()
    client = make_client_mesh(device_type="cpu")
    assert client.shape == {"clients": 1} and client.axis_sizes == (1,)
    cpu = torch.device("cpu")
    two = Mesh((cpu, cpu, cpu, cpu), ("data", "model"), (2, 2))
    assert two.shape == {"data": 2, "model": 2}
    for bad in (((cpu,) * 3, ("data", "model"), (2, 2)),
                ((), ("data",), (0,)), ((), ("a", "a"), (2, 2)),
                ((), ("data", "model"), (2,))):
        with pytest.raises(ValueError):
            Mesh(*bad)


def test_activation_policy_records_and_clears(host):
    x = torch.zeros((4, 8, 16))
    assert constrain(x, ("batch", "seq", None)) is x      # no policy
    tm = make_production_mesh()
    records = []
    set_activation_policy(make_activation_policy(
        tm, default_rules(tm), records))
    try:
        assert constrain(x, ("batch", "seq", None)) is x
        with pytest.raises(ValueError):
            constrain(x, ("batch", None))                  # wrong rank
    finally:
        set_activation_policy(None)
    assert constrain(x, ("batch", None)) is x             # cleared
    assert len(records) == 1
    rec = records[0]
    assert rec.logical == ("batch", "seq", None) and rec.shape == (4, 8, 16)
    # 4 and 8 do not divide 16: both replicate
    assert rec.sharding == Sharding(tm, P())


# constrained activations a layer: the residual, q, k, v, and the MLP's
# hidden (a MoE layer: its two)
PER_LAYER = {"olmoe-1b-7b": 6, "qwen3-14b": 5, "granite-20b": 5}


@pytest.mark.parametrize("arch", list(PER_LAYER))
def test_constrain_calls_change_no_number(arch, monkeypatch):
    """With no policy installed the forward through the constrain sites is
    bit for bit the forward with the calls taken out (the code before
    they were added); a recording policy changes no number either."""
    cfg = reduce_for_smoke(treg.get_config(arch, "train_4k"), seq_len=16,
                           batch=2)
    m = cfg.model
    params = lm_init(0, m, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, m.vocab_size, (2, 16)))
             for k in ("tokens", "labels")}
    with torch.no_grad():
        plain = lm_loss(params, batch, m)[0]
        records = []
        tm = make_production_mesh()
        set_activation_policy(make_activation_policy(
            tm, default_rules(tm), records))
        try:
            recorded = lm_loss(params, batch, m)[0]
        finally:
            set_activation_policy(None)
        for mod in (TL, TMOE, TT):
            monkeypatch.setattr(mod, "constrain", lambda x, axes: x)
        without = lm_loss(params, batch, m)[0]
    assert torch.equal(plain, without) and torch.equal(plain, recorded)
    kinds = {r.logical for r in records}
    assert {("batch", "seq", None), ("batch", None, "heads", None),
            ("batch", None, "kv", None)} <= kinds
    assert len(records) == PER_LAYER[arch] * m.num_layers


def test_collective_bytes_hand_computed():
    """The convention of ``roofline/analysis.py`` on two leaves of the
    (2, 16, 16) mesh, by hand: an FSDP + TP leaf (4096, 1024) bf16 over
    ((pod, data), model) and a replicated (1024,) fp32 leaf."""
    mesh = make_production_mesh(multi_pod=True)
    shapes = {"a": ShapeDtype((4096, 1024), torch.bfloat16),
              "b": ShapeDtype((1024,), torch.float32)}
    shard = {"a": Sharding(mesh, P(("pod", "data"), "model")),
             "b": Sharding(mesh, P())}
    assert shard_factor(shard["a"]) == 512 and shard_factor(shard["b"]) == 1
    assert rank_bytes(shapes, shard) == 4096 * 1024 * 2 / 512 + 4096
    # train, 4 micro-batches: a's gathered bytes 8 MiB / 16 (model) twice
    # a micro-batch, its 16 KiB shard reduce-scattered once; b all-reduced
    got = collective_bytes(shapes, shard, train=True, microbatches=4)
    assert got["all-gather"] == 2 * 4 * 524288
    assert got["reduce-scatter"] == 4 * 16384
    assert got["all-reduce"] == 4 * 4096
    assert got["count"] == 16 and got["total"] == 4194304 + 65536 + 16384
    serve = collective_bytes(shapes, shard, train=False, microbatches=4)
    assert serve["all-gather"] == 524288 and serve["total"] == 524288
    assert serve["count"] == 1
    host = make_host_mesh(device_type="cpu")
    none = collective_bytes(shapes, {k: Sharding(host, P())
                                     for k in shapes}, train=True)
    assert none["total"] == 0 and none["count"] == 0


def test_roofline_report_dominant():
    """Twin of tests/test_sharding_roofline.py's; the record's keys are
    the reference's."""
    kw = dict(arch="x", shape="y", mesh="m", chips=256, hlo_flops=1e15,
              hlo_bytes=1e9, collective_bytes=1e9, model_flops=2.56e17)
    r, j = RooflineReport(**kw), JReport(**kw)
    assert r.dominant == j.dominant == "compute"
    assert 0.9 < r.useful_flops_ratio < 1.1
    assert r.useful_flops_ratio == j.useful_flops_ratio
    assert r.to_dict() == j.to_dict()
    r.memory_term_s = 2.0
    assert r.dominant == "memory"


def test_kernel_terms_and_analyze_step():
    t = kernel_terms(2e12, 1e9)
    assert t["compute_term_s"] == pytest.approx(2e12 / 989e12, rel=REL)
    assert t["memory_term_s"] == pytest.approx(1e9 / 3.35e12, rel=REL)
    assert t["arithmetic_intensity"] == 2000.0
    counts = StepCounts(chips=4, flops=8e12, bytes_accessed=4e9,
                        temp_bytes=2e9, collectives={"total": 5e8},
                        param_bytes=1.0, opt_bytes=2.0, input_bytes=3.0,
                        out_bytes=4.0, act_elements=100.0,
                        act_elements_on_chip=25.0)
    assert counts.share == 0.25 and counts.arg_bytes == 6.0
    for dt, peak in (("bfloat16", 989e12), ("float32", 67e12)):
        rep = analyze_step(counts, arch="a", shape="s", mesh_name="m",
                           model_flops=8e12, compute_dtype=dt)
        assert rep.hlo_flops == 2e12 and rep.hlo_bytes == 1e9
        assert rep.temp_bytes_per_device == 5e8
        assert rep.compute_term_s == pytest.approx(2e12 / peak, rel=REL)
        assert rep.collective_term_s == pytest.approx(5e8 / 50e9, rel=REL)
        assert rep.useful_flops_ratio == 1.0
    assert H100.link_bw_per_link * 18 == pytest.approx(900e9, rel=REL)
    no_acts = dataclasses.replace(counts, act_elements=0.0,
                                  batch_share=0.5)
    assert no_acts.share == 0.5


def test_step_trace_counts_bytes_and_peak():
    """Operands and results of each op, views skipped; the peak of the
    storages made inside."""
    keep = torch.ones(10)                      # made before: not counted
    with StepTrace() as t:
        a = torch.ones(1000)                   # writes 4000
        b = torch.mul(a, a)                    # reads 8000, writes 4000
        assert (t.bytes_accessed, t.peak_bytes) == (16000, 8000)
        del a
        c = b.view(10, 100)                    # a view: nothing
        d = b + keep.sum()                     # sum 40 + 4; add 4004 + 4000
        assert t.bytes_accessed == 16000 + 44 + 8004
        # the sum's 4 bytes lived until the add was done
        assert t.live_bytes == 8000 and t.peak_bytes == 8004
        keep[2:5].add_(1.0)                    # in place: reads and writes
        assert t.bytes_accessed == 16000 + 44 + 8004 + 24
        assert t.live_bytes == 8000            # made nothing
    del c, d
