"""Multi-pod dry run: prove the distribution config coherent, and count it.
Port of ``repro/launch/dryrun.py``.

For every (architecture x input shape) pair this runs the real step
(``runtime.make_train_step`` / ``make_prefill_step`` / ``make_decode_step``)
once on fake tensors (``FakeTensorMode`` on a fake CPU device: shapes and
dtypes, no memory) with the parameter, optimizer and input trees laid out
on the production mesh, an abstract (16, 16) mesh over (data, model) or
(2, 16, 16) over (pod, data, model), and the recording activation policy
installed.  It counts what the reference reads from XLA's
``memory_analysis()`` and ``cost_analysis()`` (``roofline/analysis.py``
says how) and writes a JSON record a combination under
``experiments/dryrun_torch/``.

Where the reference compiles the whole scanned depth, the port traces
``TRACE_PERIODS`` layer periods (plus any tail) and at most
``TRACE_MICROBATCHES`` micro-batches: a trace costs seconds a layer and
micro-batch at full width, and the counts are affine in both, so the
probes (``roofline/probes.py``) carry them to the full step; the traced
config's own count is held against the probes' prediction for it.
Parameter, optimizer and input bytes and the collectives come from the
full-depth shardings directly.  Every record says ``"tensors": "fake"``;
fake CPU tensors take each kernel op's plain version (``"kernels":
"plain"``), and a train config's ``parallel.use_flash_kernel`` (which the
train step refuses: the kernels are forward-only) is cleared for the
trace and reported in the record.  No card is needed.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import RunConfig
from repro_torch.configs.registry import (ASSIGNED_ARCHS, SHAPES, SkippedShape,
                                          get_config)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.models.blocks import split_periods
from repro_torch.models.transformer import decode_state_specs
from repro_torch.roofline.analysis import (StepCounts, StepTrace,
                                           analyze_step, collective_bytes,
                                           rank_bytes, shard_factor)
from repro_torch.roofline.probes import _probe_cfg, cfg_key, probe_costs
from repro_torch.runtime import (make_decode_step, make_prefill_step,
                                 make_train_step)
from repro_torch.sharding.specs import (Sharding, logical_spec,
                                        make_activation_policy,
                                        set_activation_policy,
                                        tree_shardings)
from repro_torch.tree import shapes_of

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
TRACE_PERIODS = 2
TRACE_MICROBATCHES = 3


def _layout(cfg: RunConfig, mesh, pshapes, ins) -> Dict[str, Any]:
    """What the shardings alone give: parameter, optimizer and input bytes
    a rank, and the step's collectives."""
    psh = S.param_shardings(cfg, mesh, pshapes)
    train = cfg.shape.mode == "train"
    out = {"psh": psh, "bsh": S.batch_shardings(cfg, mesh, ins),
           "param_bytes": rank_bytes(pshapes, psh), "opt_bytes": 0.0,
           "collectives": collective_bytes(
               pshapes, psh, train=train,
               microbatches=cfg.parallel.microbatches)}
    out["input_bytes"] = rank_bytes(ins, out["bsh"])
    if train:
        oshapes = S.opt_shapes(cfg, pshapes)
        out["oshapes"] = oshapes
        out["osh"] = S.opt_shardings(cfg, mesh, pshapes)
        out["opt_bytes"] = rank_bytes(oshapes, out["osh"])
    return out


def _activation_elements(records) -> Tuple[float, float]:
    """The constrained activations' elements, and how many of them a chip
    holds under their specs."""
    total = on_chip = 0.0
    for r in records:
        n = float(math.prod(r.shape))
        total += n
        on_chip += n / shard_factor(r.sharding)
    return total, on_chip


def lower_one(cfg: RunConfig, mesh) -> StepCounts:
    """Run cfg's step once on fake tensors with the shardings of ``mesh``
    and the recording activation policy installed, under
    ``FlopCounterMode`` and a :class:`StepTrace`; return its counts."""
    rules = S.make_rules(cfg, mesh)
    records: list = []
    set_activation_policy(make_activation_policy(mesh, rules, records))
    try:
        mode = cfg.shape.mode
        pshapes = S.param_shapes(cfg)
        ins = S.input_specs(cfg)
        lay = _layout(cfg, mesh, pshapes, ins)
        run = (cfg.override({"parallel.use_flash_kernel": False})
               if mode == "train" else cfg)
        trace = StepTrace()
        t0 = time.perf_counter()
        with FakeTensorMode():
            params = S.fake_tree(pshapes)
            if mode == "train":
                opt, batch = S.fake_tree(lay["oshapes"]), S.fake_tree(ins)
            elif mode == "prefill":
                batch = S.fake_tree(ins)
            else:
                token, state = S.fake_tree(ins["token"]), \
                    S.fake_tree(ins["state"])
            with FlopCounterMode(display=False) as flops, trace:
                if mode == "train":
                    out = make_train_step(run)(params, opt, batch, 0)
                elif mode == "prefill":
                    out = make_prefill_step(run)(params, batch)
                else:
                    out = make_decode_step(run)(params, token, state,
                                                cfg.shape.seq_len - 1)
            if mode != "train":     # the logits and the decode state
                outs = shapes_of({"logits": out[0], "state": out[1]})
        secs = time.perf_counter() - t0
    finally:
        set_activation_policy(None)

    if mode == "train":
        out_bytes = lay["param_bytes"] + lay["opt_bytes"]
    else:
        logits = outs["logits"]
        spec = logical_spec(mesh, rules, logits.shape, ("batch", "vocab"))
        out_bytes = logits.nbytes / shard_factor(Sharding(mesh, spec)) \
            + rank_bytes(outs["state"], tree_shardings(
                mesh, rules, outs["state"], decode_state_specs(cfg.model)))
    acts, acts_on_chip = _activation_elements(records)
    batch_sh = lay["bsh"]["tokens" if mode != "decode" else "token"]
    return StepCounts(
        chips=mesh_chips(mesh), flops=float(flops.get_total_flops()),
        bytes_accessed=float(trace.bytes_accessed),
        temp_bytes=float(trace.peak_bytes),
        collectives=lay["collectives"],
        param_bytes=lay["param_bytes"], opt_bytes=lay["opt_bytes"],
        input_bytes=lay["input_bytes"], out_bytes=out_bytes,
        act_elements=acts, act_elements_on_chip=acts_on_chip,
        batch_share=1.0 / shard_factor(batch_sh), activations=records,
        seconds=secs)


def traced_cfg(cfg: RunConfig) -> RunConfig:
    """The configuration the dry run traces directly: at most
    ``TRACE_PERIODS`` layer periods plus the tail, and (train) at most
    ``TRACE_MICROBATCHES`` micro-batches of the production size."""
    n_full, _ = split_periods(cfg.model)
    nmb = max(1, cfg.parallel.microbatches)
    return _probe_cfg(cfg, min(n_full, TRACE_PERIODS),
                      min(nmb, TRACE_MICROBATCHES) if cfg.shape.mode
                      == "train" else nmb, include_tail=True)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def run_pair(arch: str, shape: str, multi_pod: bool,
             out_dir: str = OUT_DIR, verbose: bool = True,
             probes: bool = True) -> Optional[Dict[str, Any]]:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}_{shape}_{mesh_name}.json")
    try:
        cfg = get_config(arch, shape)
    except SkippedShape as e:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "status": "skipped", "reason": str(e)}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)
        if verbose:
            print(f"[skip] {arch} x {shape}: {e}")
        return rec
    t_pair = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    traced = traced_cfg(cfg)
    try:
        counts = lower_one(traced, mesh)
        full = _layout(cfg, mesh, S.param_shapes(cfg), S.input_specs(cfg))
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)
        print(f"[FAIL] {arch} x {shape} ({mesh_name}): {e}")
        return rec

    # the traced config's measurement, as a probe's
    direct = {"flops": counts.flops, "bytes": counts.bytes_accessed,
              "coll": float(counts.collectives["total"]),
              "temp": counts.temp_bytes, "act": counts.act_elements,
              "act_chip": counts.act_elements_on_chip}
    # the shardings' counts at full depth; the traced ones at cut depth
    counts = dataclasses.replace(
        counts, param_bytes=full["param_bytes"], opt_bytes=full["opt_bytes"],
        input_bytes=full["input_bytes"], collectives=full["collectives"],
        out_bytes=(full["param_bytes"] + full["opt_bytes"]
                   if cfg.shape.mode == "train" else counts.out_bytes))
    # tokens per step for MODEL_FLOPS = 6*N*D (decode: 1 token per seq)
    b, seq = S.batch_tokens(cfg)
    tokens = b if cfg.shape.mode == "decode" else b * seq
    n_active = cfg.model.active_param_count()
    factor = 6.0 if cfg.shape.mode == "train" else 2.0
    model_flops = factor * n_active * tokens
    cd = cfg.parallel.compute_dtype
    # full-depth counts via probe differencing
    try:
        if not probes:
            raise RuntimeError("probes disabled (--no-probes)")
        # the traced config is measured already (a probe config when the
        # step has at most 2 periods or micro-batches)
        cache: Dict[str, Any] = {cfg_key(traced): direct}
        pc = probe_costs(cfg, mesh, cache)
        at_traced = probe_costs(traced, mesh, cache)
        probe_terms: Dict[str, Any] = dict(pc)
        # the probes' prediction at the traced depth against its trace
        probe_terms["direct_check"] = {
            k: _rel(at_traced[k]["total"], v) for k, v in direct.items()
            if k != "coll"}
        counts = dataclasses.replace(
            counts, flops=pc["flops"]["total"],
            bytes_accessed=pc["bytes"]["total"],
            temp_bytes=pc["temp"]["total"],
            act_elements=pc["act"]["total"],
            act_elements_on_chip=pc["act_chip"]["total"])
    except Exception as e:  # probes are best-effort; keep the traced counts
        probe_terms = {"error": f"{type(e).__name__}: {e}"}
    rep = analyze_step(counts, arch=arch, shape=shape, mesh_name=mesh_name,
                       model_flops=model_flops, compute_dtype=cd)
    n_full, _ = split_periods(cfg.model)
    rec = rep.to_dict()
    rec.update(status="ok", compile_s=counts.seconds, mode=cfg.shape.mode,
               params=cfg.model.param_count(),
               active_params=n_active, tokens_per_step=tokens,
               probe_terms=probe_terms, tensors="fake", kernels="plain",
               use_flash_kernel=cfg.parallel.use_flash_kernel,
               periods=n_full, microbatches=cfg.parallel.microbatches,
               traced_periods=split_periods(traced.model)[0],
               traced_microbatches=traced.parallel.microbatches,
               param_bytes_per_device=counts.param_bytes,
               opt_bytes_per_device=counts.opt_bytes,
               input_bytes_per_device=counts.input_bytes,
               pair_s=time.perf_counter() - t_pair,
               activations={"constrained_at_traced_depth":
                                len(counts.activations),
                            "share_on_chip": counts.share})
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=2)
    if verbose:
        mem = (rep.arg_bytes_per_device + rep.temp_bytes_per_device) / 1e9
        print(f"[ok] {arch:22s} {shape:12s} {mesh_name:10s} "
              f"trace={counts.seconds:6.1f}s pair={rec['pair_s']:6.1f}s "
              f"flops/chip={rep.hlo_flops:.3e} "
              f"coll={rep.collective_bytes:.3e}B dom={rep.dominant} "
              f"mem(args+act)={mem:.2f}GB")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="trace only (counts at the traced depth)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = SHAPES if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                out_path = os.path.join(args.out,
                                        f"{a}_{s}_{mesh_name}.json")
                if args.skip_existing and os.path.exists(out_path):
                    with open(out_path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[cached] {a} x {s} ({mesh_name})")
                        continue
                rec = run_pair(a, s, mp, args.out,
                               probes=not args.no_probes)
                if rec and rec.get("status") == "error":
                    failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
