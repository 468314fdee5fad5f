"""Probe-differencing cost accounting.  Port of ``repro/roofline/probes.py``.

The reference needs this because XLA's ``cost_analysis()`` counts a
while-loop body once, so the scanned production module under-reports by
the trip counts.  The port's dry run traces every layer and micro-batch
it runs, so its counts are right at any depth; what a full-depth trace
costs is time (a few seconds a layer and micro-batch at full width, about
ten minutes for llama3-405b's 126 layers).  So the port, too, traces small
probes at full width and carries them to full depth with the reference's
algebra.  Cost is modelled as

    F(d, nmb) = A + B*nmb + C*d + D*d*nmb        (train)
    F(d)      = A + C*d                          (prefill / decode)

where d = number of layer *periods*, nmb = number of microbatches:
  A  fixed (optimizer on embed/head, bookkeeping)
  B  per-microbatch embed/loss fwd+bwd
  C  per-period optimizer update (+ per-period fixed)
  D  per-period per-microbatch fwd+bwd

Probes:
  train:   (d=1, m=1), (d=2, m=1), (d=1, m=2), (d=2, m=2)
  serve:   (d=1), (d=2)
plus tail probes (d=1+tail) when depth % period != 0 (recurrentgemma).
Every probe keeps the production per-microbatch token count, so D is exact
for the production batch geometry.  Each key the measurement returns
is carried the same way: flops, bytes and collective bytes as in the
reference, and the port's activation element counts (``_measure``), all
exactly affine in d and nmb; and the activation peak, a maximum over the
step, which is affine only near enough: exactly for a train step of one
layer kind, off by a few percent at smoke size where a tail or the
prefill's gathered cache moves the maximum (recurrentgemma's train step
5%, deepseek's prefill 7%).
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from repro_torch.config import RunConfig
from repro_torch.models.blocks import period_of, split_periods


def _probe_cfg(cfg: RunConfig, depth_periods: int, nmb: int,
               include_tail: bool = False) -> RunConfig:
    period_len = len(period_of(cfg.model))
    n_full, rem = split_periods(cfg.model)
    depth = depth_periods * period_len + (len(rem) if include_tail else 0)
    pmb_batch = cfg.shape.global_batch // max(1, cfg.parallel.microbatches)
    d = cfg.to_dict()
    d["model"]["num_layers"] = depth
    d["parallel"]["scan_layers"] = False
    d["parallel"]["unroll_microbatches"] = True
    d["parallel"]["microbatches"] = nmb
    if cfg.shape.mode == "train":
        d["shape"]["global_batch"] = pmb_batch * nmb
    return RunConfig.from_dict(d)


def cfg_key(cfg: RunConfig) -> str:
    """A probe configuration's key in a measurement cache."""
    return json.dumps(cfg.to_dict(), sort_keys=True)


def _measure(cfg: RunConfig, mesh) -> Dict[str, float]:
    """Trace one probe (``launch/dryrun.lower_one``): the step's flops,
    bytes accessed and activation peak, a chip's collective bytes, and
    the constrained activations' elements and a chip's of them (the
    dry run takes a chip's share of the first three from the last two)."""
    from repro_torch.launch.dryrun import lower_one
    c = lower_one(cfg, mesh)
    return {"flops": c.flops, "bytes": c.bytes_accessed,
            "coll": float(c.collectives["total"]), "temp": c.temp_bytes,
            "act": c.act_elements, "act_chip": c.act_elements_on_chip}


def probe_costs(cfg: RunConfig, mesh, cache: Optional[Dict] = None
                ) -> Dict[str, Dict[str, float]]:
    """Derive production-trip-count cost terms for cfg on mesh.

    Returns {key: {"A", "B", "C", "D", "total"}} for each key of the
    measurement.  ``cache`` (a dict) keeps the probes' measurements by
    their configuration (:func:`cfg_key`), for several calls on one
    mesh.
    """
    def measure(c: RunConfig) -> Dict[str, float]:
        if cache is None:
            return _measure(c, mesh)
        key = cfg_key(c)
        if key not in cache:
            cache[key] = _measure(c, mesh)
        return cache[key]

    n_full, rem = split_periods(cfg.model)
    nmb = max(1, cfg.parallel.microbatches)
    train = cfg.shape.mode == "train"

    f11 = measure(_probe_cfg(cfg, 1, 1))
    f21 = measure(_probe_cfg(cfg, 2, 1))
    if train:
        f12 = measure(_probe_cfg(cfg, 1, 2))
        f22 = measure(_probe_cfg(cfg, 2, 2))
    if rem:
        t11 = measure(_probe_cfg(cfg, 1, 1, include_tail=True))
        if train:
            t12 = measure(_probe_cfg(cfg, 1, 2, include_tail=True))

    out: Dict[str, Dict[str, float]] = {}
    for key in f11:
        if train:
            D = f22[key] - f21[key] - f12[key] + f11[key]
            C = f21[key] - f11[key] - D
            B = f12[key] - f11[key] - D
            A = f11[key] - B - C - D
            total = A + B * nmb + C * n_full + D * n_full * nmb
            if rem:
                # tail delta vs the d=1 probe: m=1 gives C_t + D_t,
                # m=2 gives C_t + 2*D_t  =>  solve both tail terms
                Dt = (t12[key] - f12[key]) - (t11[key] - f11[key])
                Ct = (t11[key] - f11[key]) - Dt
                total += Ct + Dt * nmb
        else:
            D = 0.0
            B = 0.0
            C = f21[key] - f11[key]
            A = f11[key] - C
            total = A + C * n_full
            if rem:
                total += t11[key] - f11[key]
        # differencing can go slightly negative on near-zero terms; clamp
        # (costs are nonnegative)
        out[key] = {"A": A, "B": B, "C": C, "D": D,
                    "total": max(total, 0.0)}
    return out
