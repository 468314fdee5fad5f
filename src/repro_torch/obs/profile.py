"""Profiling hooks: per-kernel timing feeding the roofline model.  Port of
``repro/obs/profile.py``.

Everything here is measurement-only and OFF by default
(``cfg.obs.profile_kernels=False``): profiling launches the hot
aggregation, privacy and boundary kernels (fedavg, dp_clip, boundary_fuse,
agg_fuse's dequant_reduce) on synthetic inputs, so the gate keeps
``control=frozen`` runs doing no extra work; numerics are untouched either
way (the profiled calls never feed training state).

On a CUDA device each profile launches the hand-written kernel (the plain
version where the config leaves the kernel off); on the CPU it runs the
plain version.  Each profile records:

  * ``compile_s`` — the first call's wall time, which includes the
    kernel's build or load; ``lower_s`` is 0 (nothing is lowered);
  * ``run_s``     — the best of ``runs`` timed calls: CUDA events around
    each call on the card, the host clock on the CPU;
  * the roofline terms of the call's shapes on the H100
    (``repro_torch.roofline.analysis``): flops and bytes, the compute
    and memory terms, the bound and which of the two gives it.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.roofline.analysis import (agg_fuse_terms, dp_clip_terms,
                                           fedavg_terms,
                                           fused_boundary_terms)
from repro_torch.roofline.hw import H100, HwSpec

# timed calls a profile takes after its first (untimed) one
PROFILE_RUNS = 3

Device = Optional[Union[str, torch.device]]


@dataclass
class KernelProfile:
    name: str
    lower_s: float
    compile_s: float
    run_s: float                  # best-of-N executed time
    runs: int
    device: str = "cpu"
    kernel: bool = False          # the hand-written kernel ran (else plain)
    flops: float = 0.0
    bytes_accessed: float = 0.0
    compute_term_s: float = 0.0
    memory_term_s: float = 0.0
    arithmetic_intensity: float = 0.0
    bound_s: float = 0.0
    bound_by: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def profile_call(name: str, fn: Callable, *args, device: torch.device,
                 kernel: bool, terms: Dict[str, Any],
                 runs: int = PROFILE_RUNS) -> KernelProfile:
    """Time one call on ``args`` (the reference's ``profile_jit``): the
    first call's wall time, then the best of ``runs`` timed calls."""
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(max(1, runs)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            r0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - r0)
    keep = {k: terms[k] for k in (
        "flops", "bytes_accessed", "compute_term_s", "memory_term_s",
        "arithmetic_intensity", "bound_s", "bound_by")}
    return KernelProfile(name=name, lower_s=0.0, compile_s=compile_s,
                         run_s=best, runs=max(1, runs),
                         device=str(device), kernel=kernel, **keep)


def _normal(shape, seed: int, dev: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)


# ---------------------------------------------------------------------------
# the engine's hot kernels on synthetic inputs
# ---------------------------------------------------------------------------

def profile_fedavg(*, num_clients: int = 4, n: int = 8192,
                   device: Device = None, hw: HwSpec = H100,
                   runs: int = PROFILE_RUNS) -> KernelProfile:
    """The fedavg aggregation kernel: (C, N) stacked client updates ->
    weighted mean."""
    from repro_torch.kernels.fedavg.ops import fedavg_flat
    dev = resolve_device(device)
    stacked = _normal((num_clients, n), 0, dev)
    weights = torch.ones((num_clients,), dtype=torch.float32, device=dev)
    return profile_call(f"fedavg_c{num_clients}_n{n}", fedavg_flat, stacked,
                        weights, device=dev, kernel=dev.type == "cuda",
                        terms=fedavg_terms(num_clients, n, hw=hw), runs=runs)


def profile_dp_clip(*, batch: int = 8, n: int = 4096, clip: float = 1.0,
                    sigma: float = 1.0, use_kernel: bool = False,
                    device: Device = None, hw: HwSpec = H100,
                    runs: int = PROFILE_RUNS) -> KernelProfile:
    """The dp_clip privatization: per-example (B, N) grads -> clipped,
    noised sum (the DP-SGD inner release)."""
    from repro_torch.kernels.dp_clip.ops import dp_clip_noise_flat
    dev = resolve_device(device)
    stacked = _normal((batch, n), 1, dev)
    noise = _normal((n,), 2, dev)

    def fn(g, nz):
        return dp_clip_noise_flat(g, clip, sigma * clip, nz,
                                  use_kernel=use_kernel)

    kind = "kernel" if use_kernel else "ref"
    return profile_call(f"dp_clip_{kind}_b{batch}_n{n}", fn, stacked, noise,
                        device=dev, kernel=use_kernel and dev.type == "cuda",
                        terms=dp_clip_terms(batch, n, hw=hw), runs=runs)


def profile_boundary_fuse(*, batch: int = 8, n: int = 4096,
                          codec: str = "int8", clip: float = 1.0,
                          sigma: float = 0.5, use_kernel: bool = False,
                          device: Device = None, hw: HwSpec = H100,
                          runs: int = PROFILE_RUNS) -> KernelProfile:
    """The fused boundary-crossing stage (kernels/boundary_fuse): codec
    qdq + per-example clip + Gaussian noise over one flattened (B, N)
    boundary tensor — what every hop of a composed ``codec+dp`` split
    stage pays."""
    from repro_torch.kernels.boundary_fuse.ops import fused_boundary_flat
    dev = resolve_device(device)
    x = _normal((batch, n), 3, dev)
    noise = _normal((batch, n), 4, dev)

    def fn(t, nz):
        return fused_boundary_flat(t, clip, sigma * clip, nz, codec=codec,
                                   use_kernel=use_kernel)

    kind = "kernel" if use_kernel else "ref"
    return profile_call(
        f"boundary_fuse_{codec}_{kind}_b{batch}_n{n}", fn, x, noise,
        device=dev, kernel=use_kernel and dev.type == "cuda",
        terms=fused_boundary_terms(batch, n, codec=codec, hw=hw), runs=runs)


def profile_agg_fuse(*, num_clients: int = 4, n: int = 8192,
                     codec: str = "int8", use_kernel: bool = False,
                     device: Device = None, hw: HwSpec = H100,
                     runs: int = PROFILE_RUNS) -> KernelProfile:
    """The fused dequant-reduce server aggregation (kernels/agg_fuse):
    (C, N) compressed client wires + per-client scales -> one fp32
    weighted mean without materializing decoded trees — what
    ``fed.server_reduce != 'decode'`` replaces decode-then-fedavg with."""
    from repro_torch.kernels.agg_fuse.ops import dequant_reduce_flat
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(5)
    if codec == "int8":
        wires = torch.randint(-127, 128, (num_clients, n), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.int8)
        scales = 1e-3 + (1e-1 - 1e-3) * torch.rand(
            (num_clients,), generator=gen, device=dev, dtype=torch.float32)
    else:
        wires = torch.randn((num_clients, n), generator=gen, device=dev,
                            dtype=torch.float32)
        if codec == "fp16":
            wires = wires.to(torch.float16)
        scales = torch.ones((num_clients,), dtype=torch.float32, device=dev)
    weights = torch.ones((num_clients,), dtype=torch.float32, device=dev)

    def fn(w, s, wt):
        return dequant_reduce_flat(w, s, wt, use_kernel=use_kernel)

    kind = "kernel" if use_kernel else "ref"
    return profile_call(
        f"agg_fuse_{codec}_{kind}_c{num_clients}_n{n}", fn, wires, scales,
        weights, device=dev, kernel=use_kernel and dev.type == "cuda",
        terms=agg_fuse_terms(num_clients, n, codec=codec, hw=hw), runs=runs)


def engine_kernel_shapes(cfg) -> Dict[str, int]:
    """The shapes one engine round gives the kernels under ``cfg``:
    ``clients``, the ``batch`` of a local step, ``params`` (the
    discriminator's parameter count: a client's update, a per-example
    gradient row) and ``boundary`` (the first conv's activation per
    example: the split's widest crossing)."""
    from repro_torch.models.dcgan import disc_init
    from repro_torch.tree import leaves
    c = cfg.model.dcgan
    params = sum(l.numel() for l in leaves(disc_init(
        torch.Generator().manual_seed(0), c, "meta")))
    side = -(-c.image_size // 2)
    return {"clients": cfg.fsl.num_clients, "batch": cfg.shape.global_batch,
            "params": params, "boundary": side * side * c.base_filters}


def profile_engine_kernels(cfg=None, *, device: Device = None,
                           hw: HwSpec = H100, runs: int = PROFILE_RUNS
                           ) -> Dict[str, Dict[str, Any]]:
    """Profile the kernels one engine round leans on.  With ``cfg`` the
    shapes are the round's (``engine_kernel_shapes``) and the kernels the
    config turns on run (fedavg always; dp_clip when the privacy
    subsystem is on, through the kernel under ``privacy.use_kernel``;
    boundary_fuse when the split stage composes a dense codec with noise,
    under ``split.use_kernel``; agg_fuse when the uplink codec is dense
    and lossy, under ``fed.kernel_aggregation``).  Without it, the
    reference's small default shapes and every profile.  Returns
    ``{name: profile dict}`` — what the recorder writes to
    ``profile.json``."""
    dev = resolve_device(device)
    kw = dict(device=dev, hw=hw, runs=runs)
    if cfg is None:
        profiles = [profile_fedavg(**kw), profile_dp_clip(**kw),
                    profile_boundary_fuse(**kw), profile_agg_fuse(**kw)]
        return {p.name: p.to_dict() for p in profiles}
    sh = engine_kernel_shapes(cfg)
    clients = max(2, sh["clients"])
    profiles = [profile_fedavg(num_clients=clients, n=sh["params"], **kw)]
    if cfg.privacy.enabled:
        profiles.append(profile_dp_clip(
            batch=sh["batch"], n=sh["params"],
            use_kernel=cfg.privacy.use_kernel, **kw))
    stage = cfg.split.boundary_stage
    if "+" in stage and stage.split("+")[0] in ("fp16", "int8"):
        profiles.append(profile_boundary_fuse(
            batch=sh["batch"], n=sh["boundary"], codec=stage.split("+")[0],
            use_kernel=cfg.split.use_kernel, **kw))
    if cfg.fed.codec in ("fp16", "int8"):
        profiles.append(profile_agg_fuse(
            num_clients=clients, n=sh["params"], codec=cfg.fed.codec,
            use_kernel=cfg.fed.kernel_aggregation, **kw))
    return {p.name: p.to_dict() for p in profiles}
