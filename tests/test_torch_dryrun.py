"""The port's dry run (``launch/dryrun.py``, ``roofline/probes.py``) at
smoke size on the CPU, against the JAX package's where the two compute the
same thing.

* The probe algebra: both packages' ``probe_costs`` over one stubbed
  ``_measure`` give the same A, B, C, D and totals, exactly (the same
  float operations in the same order).
* The port's probes carry its direct counts exactly: flops, bytes,
  collectives and activation elements of a traced config equal the probe
  prediction to 1e-9 relative.
* ``lower_one``: the reference's ``test_system.py`` twins.  The train twin
  fails in the reference (its test does), so the port is held to its own
  invariants there; the decode twin is held to the reference's
  ``memory_analysis()`` byte for byte, less what XLA adds or drops.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

from repro.config import reduce_for_smoke as jreduce
from repro.configs.registry import get_config as jget
from repro.launch.mesh import make_host_mesh as jhost
from repro.roofline import probes as jprobes
from repro_torch.config import reduce_for_smoke
from repro_torch.configs.registry import SkippedShape, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.transformer import lm_init
from repro_torch.optim import make_optimizer
from repro_torch.roofline import probes as tprobes
from repro_torch.tree import leaves

REL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stub(cfg, mesh):
    """Numbers of a probe config, the same in both packages: seeded by its
    depth, micro-batches and batch."""
    key = (cfg.model.num_layers, cfg.parallel.microbatches,
           cfg.shape.global_batch, cfg.shape.mode == "train")
    rng = np.random.default_rng(abs(hash(key)) % 2 ** 32)
    return {"flops": float(rng.normal(1e12, 4e11)),
            "bytes": float(rng.normal(1e9, 8e8)),
            "coll": float(rng.uniform(0, 1e8))}


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-14b", "train_4k"),            # train, no tail
    ("recurrentgemma-9b", "train_4k"),    # train with a tail
    ("recurrentgemma-9b", "decode_32k"),  # serve with a tail
    ("llama3-405b", "decode_32k"),        # serve
    ("olmoe-1b-7b", "prefill_32k")])
def test_probe_algebra_matches_reference(arch, shape, monkeypatch):
    monkeypatch.setattr(jprobes, "_measure", _stub)
    monkeypatch.setattr(tprobes, "_measure", _stub)
    jcfg, tcfg = jget(arch, shape), get_config(arch, shape)
    for d, m, tail in ((1, 1, False), (2, 2, False), (1, 2, True)):
        assert tprobes._probe_cfg(tcfg, d, m, tail).to_dict() == \
            jprobes._probe_cfg(jcfg, d, m, tail).to_dict()
    want = jprobes.probe_costs(jcfg, None)
    got = tprobes.probe_costs(tcfg, None)
    assert got == want
    # a cache hands each probe's numbers back without measuring again
    cache = {}
    assert tprobes.probe_costs(tcfg, None, cache) == want
    monkeypatch.setattr(tprobes, "_measure", None)
    assert tprobes.probe_costs(tcfg, None, cache) == want


def test_probe_total_clamps_at_zero(monkeypatch):
    def negative(cfg, mesh):
        d = cfg.model.num_layers
        return {"flops": 10.0 - 20.0 * d, "bytes": 1.0, "coll": 0.0}
    monkeypatch.setattr(jprobes, "_measure", negative)
    monkeypatch.setattr(tprobes, "_measure", negative)
    cfg = get_config("qwen3-14b", "decode_32k")
    got = tprobes.probe_costs(cfg, None)
    assert got == jprobes.probe_costs(jget("qwen3-14b", "decode_32k"), None)
    assert got["flops"]["total"] == 0.0 and got["flops"]["C"] == -20.0


def _small(arch, shape, layers, **over):
    cfg = reduce_for_smoke(get_config(arch, shape), seq_len=16, batch=4)
    if cfg.shape.mode == "decode":
        cfg = cfg.override({"shape.seq_len": 32})
    return cfg.override({"model.num_layers": layers, **over})


# the activation peak, a maximum over the step, is left out: it is affine
# in the depth only where one layer kind repeats and nothing is gathered
# at the end (test_run_pair_record's train step holds it too)
@pytest.mark.parametrize("arch,shape,layers", [
    ("recurrentgemma-9b", "decode_32k", 8),          # a tail
    ("deepseek-v2-lite-16b", "prefill_32k", 4)])
def test_probe_total_equals_direct_count(arch, shape, layers):
    cfg = _small(arch, shape, layers)
    mesh = make_production_mesh(multi_pod=True)
    direct = tprobes._measure(cfg, mesh)
    pc = tprobes.probe_costs(cfg, mesh)
    for k in ("flops", "bytes", "coll", "act", "act_chip"):
        assert abs(pc[k]["total"] - direct[k]) <= REL * abs(direct[k]), k
    assert direct["flops"] > 0 and direct["coll"] > 0


def test_lower_one_train_path_on_host_mesh():
    """Twin of tests/test_system.py's ``test_dryrun_path_on_host_mesh``
    (olmoe train; fails in the reference): flops > 0, every byte term
    >= 0, the constrained activations recorded, and on the one-chip host
    mesh the parameter and optimizer bytes those of the real trees."""
    cfg = reduce_for_smoke(get_config("olmoe-1b-7b", "train_4k"),
                           seq_len=32, batch=4)
    c = D.lower_one(cfg, make_host_mesh(device_type="cpu"))
    assert c.flops > 0 and c.chips == 1
    for v in (c.bytes_accessed, c.temp_bytes, c.param_bytes, c.opt_bytes,
              c.input_bytes, c.out_bytes, c.collectives["total"]):
        assert v >= 0
    assert c.collectives["total"] == 0          # one chip: nothing to send
    assert c.activations and c.share == 1.0
    params = lm_init(0, cfg.model, torch.float32, "cpu")
    opt = make_optimizer(cfg.optim).init(params)
    assert c.param_bytes == sum(l.nbytes for l in leaves(params))
    assert c.opt_bytes == sum(l.nbytes for l in leaves(opt))
    assert c.input_bytes == 2 * 4 * 32 * 4      # tokens + labels, int32


def _reference_lower_one():
    """The reference's ``lower_one``.  Importing ``repro.launch.dryrun``
    sets ``XLA_FLAGS`` to 512 host devices, which would reach every JAX
    test of this process if JAX started after it: start JAX first (the
    flag then changes nothing here) and put the variable back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import lower_one
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return lower_one


def test_lower_one_decode_path_matches_reference_bytes():
    """Twin of tests/test_system.py's decode test (rwkv6-1.6b), held to the
    reference's ``memory_analysis()``: its arguments are the port's
    parameters, token and state (the index, which rwkv6's decode does not
    read, XLA drops: 4 bytes); its outputs the port's logits and state
    plus XLA's output tuple table (8 bytes a leaf)."""
    jlower = _reference_lower_one()
    jcfg = jreduce(jget("rwkv6-1.6b", "decode_32k"), seq_len=64, batch=2)
    jcfg = jcfg.override({"shape.mode": "decode", "shape.seq_len": 64})
    _, compiled, _ = jlower(jcfg, jhost())
    mem = compiled.memory_analysis()
    cfg = reduce_for_smoke(get_config("rwkv6-1.6b", "decode_32k"),
                           seq_len=64, batch=2)
    cfg = cfg.override({"shape.mode": "decode", "shape.seq_len": 64})
    c = D.lower_one(cfg, make_host_mesh(device_type="cpu"))
    assert c.arg_bytes - 4 == mem.argument_size_in_bytes
    n_out = 1 + len(leaves(D.S.input_specs(cfg)["state"]))
    assert c.out_bytes + 8 * n_out == mem.output_size_in_bytes
    assert c.flops > 0 and not c.activations    # rwkv decode constrains none
    assert c.share == 1.0


def test_decode_cache_written_in_place_is_not_an_activation():
    """The decode step writes its token into the cache in place: the
    activation peak counts what the step makes (a layer's cache cast to
    fp32, the scores), not the 4 layers' cache it was handed."""
    cfg = reduce_for_smoke(get_config("qwen3-14b", "decode_32k"),
                           seq_len=64, batch=2).override({
        "shape.mode": "decode", "shape.seq_len": 2048,
        "model.num_layers": 4})
    c = D.lower_one(cfg, make_host_mesh(device_type="cpu"))
    assert 0 < c.temp_bytes < c.input_bytes


REFERENCE_KEYS = {
    "arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
    "collective_bytes", "collectives", "model_flops", "compute_term_s",
    "memory_term_s", "collective_term_s", "arg_bytes_per_device",
    "temp_bytes_per_device", "out_bytes_per_device", "dominant",
    "useful_flops_ratio", "status", "compile_s", "mode", "params",
    "active_params", "tokens_per_step", "probe_terms"}


@pytest.fixture
def small_registry(monkeypatch):
    """``get_config`` of the dry run at smoke width, 5 layers; a train
    config that asks for the flash kernel."""
    def small(arch, shape):
        cfg = get_config(arch, shape)
        over = ({"parallel.use_flash_kernel": True,
                 "parallel.microbatches": 4}
                if cfg.shape.mode == "train" else {})
        return _small(arch, shape, 5, **over)
    monkeypatch.setattr(D, "get_config", small)


def test_run_pair_record(small_registry, tmp_path):
    rec = D.run_pair("qwen3-14b", "train_4k", True, str(tmp_path),
                     verbose=False)
    assert REFERENCE_KEYS <= set(rec) and rec["status"] == "ok"
    with open(tmp_path / "qwen3-14b_train_4k_pod2x16x16.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert rec["tensors"] == "fake" and rec["kernels"] == "plain"
    assert rec["use_flash_kernel"] is True       # cleared for the trace
    assert (rec["periods"], rec["traced_periods"]) == (5, 2)
    assert (rec["microbatches"], rec["traced_microbatches"]) == (4, 3)
    assert rec["chips"] == 512 and rec["mode"] == "train"
    check = rec["probe_terms"]["direct_check"]
    for k in ("flops", "bytes", "temp", "act", "act_chip"):
        assert check[k] <= REL, k
    for k in ("hlo_flops", "hlo_bytes", "collective_bytes",
              "compute_term_s", "memory_term_s", "collective_term_s",
              "arg_bytes_per_device", "temp_bytes_per_device"):
        assert np.isfinite(rec[k]) and rec[k] >= 0, k
    assert rec["hlo_flops"] > 0 and rec["collective_bytes"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    skipped = D.run_pair("whisper-base", "long_500k", False, str(tmp_path),
                         verbose=False)
    assert skipped["status"] == "skipped"


def test_dryrun_cli(small_registry, tmp_path, capsys):
    out = str(tmp_path)
    args = ["--arch", "rwkv6-1.6b", "--shape", "decode_32k", "--out", out]
    assert D.main(args + ["--no-probes"]) == 0
    with open(os.path.join(out, "rwkv6-1.6b_decode_32k_pod16x16.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok"
    assert rec["probe_terms"] == {
        "error": "RuntimeError: probes disabled (--no-probes)"}
    assert D.main(args + ["--skip-existing"]) == 0
    assert "[cached]" in capsys.readouterr().out
    with pytest.raises(SkippedShape):
        get_config("whisper-base", "long_500k")
