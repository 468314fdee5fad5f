#!/usr/bin/env python3
"""Where the time goes on the port's LM paths and inside its dp_clip,
wkv6, boundary_fuse and scatter_acc kernels, on one NVIDIA GPU.

    python3 profile_lm.py [--arch qwen3-14b rwkv6-1.6b] [--kernels]

For each architecture at full width (random weights from seed 0): serving
as ``chip_smoke.py`` drives it (4 requests of 128-1024 prompt tokens, 16
greedy tokens, bf16 cache) twice, with the prefill time and every decode
step's time (host clock, each step ending in a host read of the tokens);
then the ``lm_loss`` forward (qwen3-14b B 2 x S 2048, rwkv6-1.6b B 4 x
T 2048) warm, through the kernels and through the plain path, with the
loss of each.  Two decode steps, the qwen3-14b prefill and the forward
through the kernels are traced with ``torch.profiler``: for each, the
trace window, the time some kernel was running (the union of the
kernels' intervals) and its share of the window, the number of kernel
launches, and the kernels that take the most time.  The profiler's own
cost is inside the window, so the busy share is a lower bound.

``--kernels`` first measures the two kernels at the main paths' shapes:
dp_clip on a (256, 1,030,913) fp32 stack (the dcgan-mnist discriminator
at batch 256) beside ``vector_norm`` + ``addmv``, and wkv6 at
(4, 2048, 32, 64) fp32 with a state, traced, with the mean device time a
call of each CUDA kernel they launch (and wkv6's time a serial step);
then one warm DP-SGD round of dcgan-mnist at full width (5 clients, batch
256), with the device time of each ``torch.cat`` that flattens the
per-example gradient tree into the stack and of each dp_clip call on it
(CUDA events around each).  ``--kernels`` also traces boundary_fuse on
the split path's int8 crossings, (256, 6272) and (256, 4096), with the
tensor-wide and the per-row amax, and scatter_acc over a round's top-k
folds (5 clients x the 12 D leaves, K = 1% of each), each with its eager
time (CUDA events around back-to-back calls, host dispatch included).
The script measures the checkout it sits in: a copy of it in another
checkout measures that one (where that checkout's boundary_fuse has no
amax mode it is timed with the tensor-wide amax alone, and where its
agg_fuse has no leaf table the folds are timed one launch a leaf).
``--arch`` with no name skips the architectures.
"""
import argparse
import functools
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FORWARD = {"qwen3-14b": (2, 2048), "rwkv6-1.6b": (4, 2048)}
REQUESTS, GEN_TOKENS = 4, 16
DP_BATCH, DP_CLIENTS = 256, 5
WKV_SHAPE = (4, 2048, 32, 64)
BOUNDARY_SHAPES = ((256, 6272), (256, 4096))


def trace(prof):
    """The timed events of a finished profile, and its kernels among them."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    timed = [e for e in events if "ts" in e and "dur" in e]
    return timed, [e for e in timed if e.get("cat") == "kernel"]


def busy(prof, label, top=8):
    """Kernel busy time and share of the traced window, from the trace."""
    timed, kernels = trace(prof)
    t0 = min(e["ts"] for e in timed)
    t1 = max(e["ts"] + e["dur"] for e in timed)
    total, start, end = 0.0, None, None
    for s, e in sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    by_name = {}
    for k in kernels:
        by_name[k["name"][:70]] = by_name.get(k["name"][:70], 0.0) + k["dur"]
    print(f"{label}: trace window {(t1 - t0) / 1e3:.2f} ms, kernels busy "
          f"{total / 1e3:.2f} ms (busy share {total / (t1 - t0):.3f}), "
          f"{len(kernels)} kernel launches")
    for name, dur in sorted(by_name.items(), key=lambda x: -x[1])[:top]:
        print(f"    {dur / 1e3:9.3f} ms  {name}")


def per_kernel(label, fn, calls):
    """Traces ``calls`` calls of ``fn`` after a warm-up call and prints the
    mean device time a call of each CUDA kernel they launch; returns the
    sum in microseconds."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    kernels = trace(prof)[1]
    for k in kernels:
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"] / calls
    total = sum(by_name.values())
    print(f"{label}: {total / 1e3:.4f} ms device a call, "
          f"{len(kernels) / calls:g} kernel launches a call")
    for name, us in sorted(by_name.items(), key=lambda x: -x[1]):
        print(f"    {us / 1e3:9.4f} ms  {name[:90]}")
    return total


def eager_ms(fn, iters=200):
    """Mean milliseconds of ``fn`` called back to back (host dispatch
    included), from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def boundary_fuse_cases(dev):
    """(label, call) of the boundary_fuse kernel at the split path's int8
    crossings, in each amax mode the checkout has."""
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel

    modes = (("tensor", "row") if "amax" in inspect.signature(
        boundary_fuse_kernel).parameters else ("tensor",))
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for b, n in BOUNDARY_SHAPES:
        x = torch.randn((b, n), generator=gen, device=dev) * 0.05
        z = torch.randn((b, n), generator=gen, device=dev)
        for mode in modes:
            kw = {} if mode == "tensor" else {"amax": mode}
            cases.append((f"boundary_fuse int8 ({b}, {n}) amax={mode}",
                          functools.partial(boundary_fuse_kernel, x, 1.0,
                                            0.5, z, codec="int8", **kw)))
    return cases


def scatter_acc_case(dev):
    """(label, call) of scatter_acc over a round's top-k folds: 5 clients
    x the 12 D leaves, one launch a fold where the checkout has the leaf
    table, else one a leaf."""
    from repro_torch.configs.registry import get_config
    from repro_torch.fed.transport import make_codec
    from repro_torch.kernels.agg_fuse import kernel
    from repro_torch.models.dcgan import disc_init
    from repro_torch.tree import leaves

    sizes = [l.numel() for l in leaves(disc_init(
        torch.Generator().manual_seed(0),
        get_config("dcgan-mnist").model.dcgan, "meta"))]
    gen = torch.Generator(device=dev).manual_seed(4)
    codec = make_codec("topk")
    accs = [torch.zeros((n,), device=dev) for n in sizes]
    folds = []
    for c in range(DP_CLIENTS):
        wires = [codec.encode(torch.randn((n,), generator=gen, device=dev)
                              * 4e-4)[0] for n in sizes]
        folds.append(([v for v, _ in wires], [i for _, i in wires],
                      0.5 + 0.1 * c))
    if hasattr(kernel, "scatter_acc_leaves_kernel"):
        def call():
            for vals, idx, w in folds:
                kernel.scatter_acc_leaves_kernel(accs, vals, idx, w)
        how = "one launch a fold"
    else:
        def call():
            for vals, idx, w in folds:
                for a, v, i in zip(accs, vals, idx):
                    kernel.scatter_acc_kernel(a, v, i, w)
        how = "one launch a leaf"
    kept = sum(v.numel() for vals, _, _ in folds for v in vals)
    return (f"scatter_acc, a round's {len(folds)} top-k folds of "
            f"{len(sizes)} leaves ({kept} kept entries), {how}", call)


def profile_dp_clip(dev):
    """The dp_clip kernel's passes at the DP-SGD path's stack, beside
    ``vector_norm`` + ``addmv``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
    from repro_torch.models.dcgan import disc_init
    from repro_torch.tree import leaves

    n = sum(l.numel() for l in leaves(disc_init(
        torch.Generator().manual_seed(0),
        get_config("dcgan-mnist").model.dcgan, "meta")))
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = torch.logspace(-4.0, -2.0, DP_BATCH, device=dev)
    x = torch.randn((DP_BATCH, n), generator=gen, device=dev) * rows[:, None]
    z = torch.randn((n,), generator=gen, device=dev)
    floor = 1e3 * (2 * 4 * DP_BATCH * n + 8 * n) / 3.35e12
    print(f"dp_clip ({DP_BATCH}, {n}): two reads of the stack + z + out at "
          f"3.35 TB/s: {floor:.4f} ms")
    per_kernel("dp_clip kernel",
               lambda: dp_clip_noise_kernel(x, 1.0, 1.0, z), 10)

    def library():
        s = torch.clamp(1.0 / torch.clamp(torch.linalg.vector_norm(
            x, dim=1), min=1e-12), max=1.0)
        return torch.addmv(z, x.T, s)

    per_kernel("vector_norm + addmv", library, 10)


def profile_dp_round(dev):
    """One warm DP-SGD round at full width: the device time of each flatten
    and of each dp_clip call (CUDA events around each)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gan import FSLGANTrainer
    from repro_torch.data import partition_dirichlet, synthetic_mnist
    from repro_torch.kernels.dp_clip import ops

    events = {"flatten_per_example": [], "dp_clip_noise_kernel": []}

    def timed(name):
        fn = getattr(ops, name)

        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events[name].append((start, end))
            return out
        return fn, call

    cfg = get_config("dcgan-mnist").override({
        "fed.kernel_aggregation": True, "privacy.enabled": True,
        "privacy.mode": "dp_sgd", "privacy.clip_norm": 1.0,
        "privacy.noise_multiplier": 1.0, "privacy.use_kernel": True})
    imgs, labels = synthetic_mnist(4 * DP_BATCH * DP_CLIENTS, seed=0)
    parts = partition_dirichlet(imgs, labels, DP_CLIENTS, alpha=0.5, seed=0)
    tr = FSLGANTrainer(cfg, parts, seed=0)
    tr.train_epoch(batches_per_client=1)            # warm-up
    torch.cuda.synchronize()
    saved = {name: timed(name) for name in events}
    for name, (_, call) in saved.items():
        setattr(ops, name, call)
    try:
        t0 = time.perf_counter()
        tr.train_epoch(batches_per_client=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, (fn, _) in saved.items():
            setattr(ops, name, fn)
    ms = {name: ", ".join(f"{s.elapsed_time(e):.4f}" for s, e in ev)
          for name, ev in events.items()}
    print(f"DP-SGD round (dcgan-mnist, {DP_CLIENTS} clients x 1 batch of "
          f"{DP_BATCH}): wall {wall:.3f} s; the torch.cat of the "
          f"per-example gradients into the stack: {ms['flatten_per_example']}"
          f" ms; the dp_clip kernel on it: {ms['dp_clip_noise_kernel']} ms "
          f"(CUDA events around each call)")


def profile_wkv6(dev):
    """The wkv6 kernel at the rwkv6-1.6b forward's shape, with a state."""
    from repro_torch.kernels.wkv6.kernel import wkv6_kernel

    gen = torch.Generator(device=dev).manual_seed(6)
    b, t, h, n = WKV_SHAPE
    r, k, v = (torch.randn(WKV_SHAPE, generator=gen, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * torch.randn(WKV_SHAPE, generator=gen,
                                               device=dev)))
    u = 0.1 * torch.randn((h, n), generator=gen, device=dev)
    s0 = 0.1 * torch.randn((b, h, n, n), generator=gen, device=dev)
    total = per_kernel(f"wkv6 {WKV_SHAPE}",
                       lambda: wkv6_kernel(r, k, v, w, u, s0), 5)
    print(f"wkv6: {total / t:.4f} us a serial step")


def profile_arch(arch, dev):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_lm_batch, synthetic_tokens
    from repro_torch.models.transformer import lm_init, lm_loss
    from repro_torch.runtime import make_decode_step, make_prefill_step
    from repro_torch.runtime.serve import _dtype

    cfg = get_config(arch, "decode_32k")
    m = cfg.model
    params = lm_init(0, m, _dtype(cfg.parallel.param_dtype), dev)
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(128, 1025, REQUESTS)]
    max_len = max(lens)
    toks = np.zeros((REQUESTS, max_len), np.int32)
    for i, n in enumerate(lens):       # left-padded, as serve_batch does
        toks[i, max_len - n:] = synthetic_tokens(1, n, m.vocab_size,
                                                 seed=i)[0]
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    prefill = make_prefill_step(
        cfg.override({"shape.seq_len": max_len + GEN_TOKENS}))
    decode = make_decode_step(cfg)
    cd = _dtype(cfg.parallel.compute_dtype)
    with torch.no_grad():
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state, index = prefill(params, batch)
            tok = torch.argmax(logits, -1)
            torch.cuda.synchronize()
            pre = time.perf_counter() - t0
            steps = []
            for s in range(GEN_TOKENS):
                t0 = time.perf_counter()
                logits, state = decode(params, tok, state, index + s)
                tok = torch.argmax(logits, -1)
                tok.tolist()
                steps.append(round(1e3 * (time.perf_counter() - t0), 1))
            print(f"{arch} serve, run {rep}: prefill {REQUESTS}x{max_len} "
                  f"{pre:.3f} s, decode steps (ms) {steps}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for s in range(2):
                logits, state = decode(params, tok, state,
                                       index + GEN_TOKENS + s)
                tok = torch.argmax(logits, -1)
                tok.tolist()
        busy(prof, f"{arch} 2 decode steps")
        if arch == "qwen3-14b":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prefill(params, batch)
                torch.cuda.synchronize()
            busy(prof, f"{arch} prefill {REQUESTS}x{max_len}")
        del state
        b, s = FORWARD[arch]
        fwd = {k: torch.as_tensor(v, device=dev) for k, v in
               synthetic_lm_batch(b, s, m.vocab_size, seed=0).items()}
        losses = {}
        for use_kernel in (True, False):
            lm_loss(params, fwd, m, cd, use_kernel=use_kernel)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = lm_loss(params, fwd, m, cd, use_kernel=use_kernel)
            torch.cuda.synchronize()
            losses[use_kernel] = float(loss)
            print(f"{arch} lm_loss forward B {b} x S {s}, use_kernel="
                  f"{use_kernel}: loss {float(loss):.6f}, warm wall "
                  f"{time.perf_counter() - t0:.3f} s")
        print(f"{arch} forward: |loss through the kernels - plain loss| = "
              f"{abs(losses[True] - losses[False]):.3e}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lm_loss(params, fwd, m, cd, use_kernel=True)
            torch.cuda.synchronize()
        busy(prof, f"{arch} forward through the kernels")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(FORWARD),
                    choices=list(FORWARD))
    ap.add_argument("--kernels", action="store_true",
                    help="trace the dp_clip, wkv6, boundary_fuse and "
                         "scatter_acc kernels first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_lm: CUDA is not available; this script measures the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.kernels:
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import build
        print(f"build: {build.build(['dp_clip', 'wkv6', 'boundary_fuse',
                                     'agg_fuse'])}")
        cases = boundary_fuse_cases(dev) + [scatter_acc_case(dev)]
        # host dispatch included, before any profiler runs in the process
        eager = {label: eager_ms(call) for label, call in cases}
        profile_dp_clip(dev)
        profile_wkv6(dev)
        profile_dp_round(dev)
        for label, call in cases:
            per_kernel(label, call, 20)
            print(f"    eager {eager[label]:.4f} ms a call")
        torch.cuda.empty_cache()
    for arch in args.arch:
        profile_arch(arch, dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
