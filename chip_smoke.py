#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check
them.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases; a failure in any of them ends the script with a traceback and a
non-zero exit, and no result line:

1. the card — CUDA required; nvidia-smi's name and power limit printed;
   TF32 off, since the configuration computes in float32;
2. build — every kernel (fedavg, dp_clip, boundary_fuse, agg_fuse,
   flash_attention, wkv6), from ``src/repro_torch/csrc``, one ``nvcc``
   (sm_90a) per source, all started together;
3. kernel vs plain — each kernel on the card at the shapes the main paths
   give it, and at ragged sizes and edge cases, held against its plain
   PyTorch version; kernel, plain and library-call times from CUDA events,
   beside the card's bound for the same work;
4. the main paths — ``FSLGANTrainer.train_epoch`` on ``dcgan-mnist`` at
   full width (5 clients, batch 256, base_filters 64, latent 100, Adam
   2e-4) with ``fed.kernel_aggregation``, 2 rounds x 2 batches per client,
   seven times: plain; with DP-SGD through the dp_clip kernel
   (``privacy.use_kernel``); with the executed split and the fused
   ``int8+dp`` boundary stage through the boundary_fuse kernel
   (``split.use_kernel``); the int8 uplink with the stream server reduce
   (dequant_acc) and with the batched one (dequant_reduce); the top-k
   uplink with the stream reduce (scatter_acc); the edge hierarchy (2
   cohorts) with int8 and the stream reduce.  Then the LM substrate at
   full width: ``lm_loss`` forward (``torch.no_grad``,
   ``parallel.use_flash_kernel``) and ``serve_batch`` (4 requests, 16
   greedy tokens, bf16 cache) on qwen3-14b (40 layers, bf16, 29.5 GB;
   B 2 x S 2048: 40 flash_attention launches) and on rwkv6-1.6b (24
   layers, fp32; B 4 x T 2048: 24 wkv6 launches); serving launches
   neither, as in the reference.  Every launch count is set to 0 just
   before a path and read just after it, and must be exactly what the path
   runs;
5. the output — finite losses, every parameter on the card, generated
   images in range, epsilon finite and growing, the LAN and edge bytes the
   split and the codec predict, the server's peak of live trees, generated
   tokens in the vocabulary, the rwkv6-1.6b loss through the wkv6 kernel
   against the plain scan's at full depth; and on small inputs the kernel
   round against the sequential round with the host FedAvg, the DP-SGD
   engine round against the sequential one, the identity-stage split round
   against the unsplit one (and, under deterministic cuDNN, bit for bit in
   every leaf), one uplink-DP round with the int8 codec, the stream and
   batched reduce against the decode reduce (flat, hierarchical, fedasync,
   fedbuff), the LM forward through the kernels against the plain path,
   and prefill + decode against the teacher-forced forward (full and
   sliding-window caches).

Prints ``{"kernels": [...]}`` on a line of its own and, as the last line,
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ROUNDS, BATCHES = 2, 2
CLIENTS = 5                     # the main path's C
BATCH = 256                     # the main path's examples per batch
DP_SGD = {"privacy.enabled": True, "privacy.mode": "dp_sgd",
          "privacy.clip_norm": 1.0, "privacy.noise_multiplier": 1.0,
          "privacy.use_kernel": True}
SPLIT = {"split.enabled": True, "split.boundary_stage": "int8+dp",
         "split.stage_clip": 1.0, "split.stage_sigma": 0.5,
         "split.use_kernel": True}
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor) FLOP/s
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12
# kernel vs plain: both sum C <= 5 fp32 products, in another order (fmaf
# in client order vs PyTorch's reduction), so they differ by a few ulp
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
# Biases that feed straight into a batch norm have a zero analytic
# gradient; Adam turns their rounding-noise gradient into steps of about
# +-lr whose sign the noise picks, so they are held to lr x steps of drift
# from the start instead of to the reference.
BN_FED_BIASES = {("conv1", "b"), ("conv2", "b"), ("deconv0", "b"),
                 ("deconv1", "b")}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters=200):
    """Mean milliseconds of ``fn`` on the card, from CUDA events around
    ``iters`` back-to-back calls after one warm-up call."""
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


def graph_ms(fn, reps=20, replays=10):
    """Device milliseconds of one ``fn`` call: ``reps`` calls captured in
    a CUDA graph and replayed ``replays`` times between CUDA events, so the
    host's per-call dispatch is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def time_variants(fns, iters=200, reps=20):
    """ms of each variant in ``fns`` (kernel, plain, library), each the
    median of three turns in rotating order: "eager" as the main path
    calls them (host dispatch included), "device" from CUDA-graph replay."""
    names = list(fns)
    out = {}
    for mode, timer in (("eager", lambda f: time_ms(f, iters)),
                        ("device", lambda f: graph_ms(f, reps))):
        runs = {k: [] for k in names}
        for turn in range(3):
            for name in names[turn:] + names[:turn]:
                runs[name].append(timer(fns[name]))
        out[mode] = {k: float(np.median(v)) for k, v in runs.items()}
    return out


def bound_ms(nbytes, flops):
    """Least time the card could take: the larger of ``nbytes`` over the
    HBM rate and ``flops`` fp32 operations over the fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fedavg_bound_ms(shapes):
    """Least time the card could take for weighted reduces of these (C, N)
    stacks: the larger of bytes (stack + weights read once, output written
    once) over HBM bandwidth and 2*C*N fp32 operations over the fp32 peak."""
    nbytes = sum(4 * (c * n + c + n) for c, n in shapes)
    flops = sum(2 * c * n for c, n in shapes)
    return (*bound_ms(nbytes, flops), nbytes)


def paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]


def phase_kernel_vs_plain(dev):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.fedavg.kernel import fedavg_kernel
    from repro_torch.kernels.fedavg.ref import fedavg_ref
    from repro_torch.models.dcgan import disc_init
    from repro_torch.tree import leaves

    c = get_config("dcgan-mnist").model.dcgan
    gen = torch.Generator().manual_seed(1)
    trees = [disc_init(gen, c, dev) for _ in range(CLIENTS)]
    # the stacks the server reduce builds: one (C, N) per D leaf
    stacks = [torch.stack([l.reshape(-1) for l in ls])
              for ls in zip(*(leaves(t) for t in trees))]
    w = torch.rand(CLIENTS, generator=gen).to(dev) + 0.5
    w = w / w.sum()
    whole = torch.cat(stacks, dim=1).contiguous()       # the whole D
    ragged = [torch.randn((CLIENTS, n), generator=gen).to(dev)
              for n in (1, 4097, 999_999)]
    cases = [(s, w) for s in stacks + [whole] + ragged]
    cases += [(s[:1].contiguous(), torch.ones(1, device=dev))
              for s in (stacks[0], ragged[1])]
    max_abs = max_rel = 0.0
    for x, wx in cases:
        got, want = fedavg_kernel(x, wx), fedavg_ref(x, wx)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        err = float((got - want).abs().max())
        max_abs = max(max_abs, err)
        max_rel = max(max_rel, err / max(float(want.abs().max()), 1e-30))
    print(f"fedavg vs plain: {len(cases)} shapes, max abs err {max_abs:.3e}, "
          f"max abs err / max |plain| {max_rel:.3e} (tolerance {KERNEL_TOL})")
    print(f"fedavg: one round reduces {len(stacks)} leaves, N = "
          f"{[s.shape[1] for s in stacks]}, whole D N = {whole.shape[1]}")

    def timed(xs):
        return time_variants({
            "kernel": lambda: [fedavg_kernel(x, w) for x in xs],
            "plain": lambda: [fedavg_ref(x, w) for x in xs],
            "library": lambda: [w @ x for x in xs]})

    rows = {}
    for label, xs in (("round (12 leaves)", stacks),
                      ("largest leaf conv2.w", [stacks[int(np.argmax(
                          [s.shape[1] for s in stacks]))]]),
                      ("whole D", [whole])):
        t = timed(xs)
        bound, by, nbytes = fedavg_bound_ms([tuple(x.shape) for x in xs])
        rows[label] = (t["device"], bound, by)
        print(f"fedavg {label}: bound {bound:.4f} ms ({by}: {nbytes} B at "
              f"3.35 TB/s)")
        for mode, tm in t.items():
            print(f"  {mode:6s} kernel {tm['kernel']:.4f} ms, plain "
                  f"{tm['plain']:.4f} ms, w @ x {tm['library']:.4f} ms")
    t, bound, by = rows["round (12 leaves)"]
    return {"name": "fedavg", "route": "cuda",
            "source": "src/repro_torch/csrc/fedavg.cu",
            "replaces": "src/repro/kernels/fedavg/kernel.py:24",
            "launches": None, "max_abs_err": max_abs,
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": t["library"]}


def phase_dp_clip(dev):
    """The dp_clip kernel against its plain version: the main path's
    (256, 1,030,913) stack of per-example gradients (rows on both sides of
    the clip), N % 4 == 0, ragged N, B = 1, an all-zero row, rows all
    under the clip, B = 300, stacks whose address is off a 16-byte
    boundary, noise_scale 0 and > 0 with injected noise, each launched
    twice for the same bits; then times at the main path's shape."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
    from repro_torch.kernels.dp_clip.ref import dp_clip_noise_ref
    from repro_torch.models.dcgan import disc_init
    from repro_torch.tree import leaves

    c = get_config("dcgan-mnist").model.dcgan
    n_full = sum(l.numel() for l in leaves(disc_init(
        torch.Generator().manual_seed(0), c, "meta")))
    gen = torch.Generator(device=dev).manual_seed(2)

    def stack(b, n, lo=-4.0, hi=-2.0):
        # per-row scales 10^lo .. 10^hi: row norms ~ scale * sqrt(n)
        rows = torch.logspace(lo, hi, b, device=dev)
        x = torch.randn((b, n), generator=gen, device=dev) * rows[:, None]
        return x, torch.randn((n,), generator=gen, device=dev)

    cases = []
    for b, n in ((BATCH, n_full), (BATCH, 4096), (BATCH, 4097), (BATCH, 1),
                 (1, 4097), (1, n_full), (3, 16384)):
        x, z = stack(b, n)
        cases += [(x, z, 0.0), (x, z, 1.0)]
    x, z = stack(BATCH, 4097)
    x[0] = 0.0                                   # an all-zero example
    cases.append((x, z, 1.0))
    x, z = stack(BATCH, 4097, -6.0, -5.0)        # every row under the clip
    cases.append((x, z, 0.5))
    for b, n, off in ((300, 8193, 1), (5, 16385, 3)):
        # a stack 4 or 12 bytes off a 16-byte boundary, past a span edge
        x, z = stack(b, n)
        buf = torch.empty(b * n + off, device=dev)
        buf[off:].view(b, n).copy_(x)
        cases.append((buf[off:].view(b, n), z, 1.0))
    clip = 1.0
    max_abs = 0.0
    for x, z, ns in cases:
        got = dp_clip_noise_kernel(x, clip, ns, z)
        want = dp_clip_noise_ref(x, clip, ns, z)
        torch.cuda.synchronize()
        tol = dict(KERNEL_TOL)
        if x.shape[1] == n_full:
            # a sum of B clipped terms in another order: at most B ulps
            # of the largest column sum of magnitudes
            s = torch.clamp(clip / torch.clamp(torch.linalg.vector_norm(
                x, dim=1), min=1e-12), max=1.0)
            tol["atol"] = x.shape[0] * 2.0 ** -24 * float(
                (x.abs() * s[:, None]).sum(0).max())
        torch.testing.assert_close(got, want, **tol)
        again = dp_clip_noise_kernel(x, clip, ns, z)
        check(torch.equal(got, again), "dp_clip is not deterministic")
        max_abs = max(max_abs, float((got - want).abs().max()))
    print(f"dp_clip vs plain: {len(cases)} cases (B x N up to {BATCH} x "
          f"{n_full}, B = 300, stacks 4 and 12 bytes off a 16-byte "
          f"boundary), max abs err {max_abs:.3e} (tolerance {KERNEL_TOL}; "
          f"at N = {n_full}: atol B x 2^-24 x max column sum of |terms|); "
          f"two launches on the same input agree bit for bit")

    x, z = stack(BATCH, n_full)
    noise_scale = 1.0

    def library():
        s = torch.clamp(clip / torch.clamp(torch.linalg.vector_norm(
            x, dim=1), min=1e-12), max=1.0)
        return torch.addmv(noise_scale * z, x.T, s)

    t = time_variants({
        "kernel": lambda: dp_clip_noise_kernel(x, clip, noise_scale, z),
        "plain": lambda: dp_clip_noise_ref(x, clip, noise_scale, z),
        "library": library}, iters=20, reps=5)
    b, n = x.shape
    nbytes = 4 * (b * n + n + n)
    bound, by = bound_ms(nbytes, 4 * b * n + 2 * n)
    print(f"dp_clip ({b}, {n}): bound {bound:.4f} ms ({by}: {nbytes} B at "
          f"3.35 TB/s, each input read once); two reads of the stack, "
          f"which no L2 can spare at 1.06 GB: "
          f"{1e3 * (2 * 4 * b * n + 8 * n) / HBM_BPS:.4f} ms")
    for mode, tm in t.items():
        print(f"  {mode:6s} kernel {tm['kernel']:.4f} ms, plain "
              f"{tm['plain']:.4f} ms, vector_norm + addmv "
              f"{tm['library']:.4f} ms")
    d = t["device"]
    return {"name": "dp_clip", "route": "cuda",
            "source": "src/repro_torch/csrc/dp_clip.cu",
            "replaces": "src/repro/kernels/dp_clip/kernel.py:58",
            "launches": None, "max_abs_err": max_abs,
            "ms": d["kernel"], "plain_ms": d["plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": d["library"]}


# operations a boundary element costs: qdq (int8: |x|, max, divide, round,
# two clamps, multiply; fp16: two conversions), the square-and-add of the
# norm, the scale and the noise fma
BOUNDARY_OPS = {"none": 5, "fp16": 7, "int8": 12}


def phase_boundary_fuse(dev):
    """The boundary_fuse kernel against its plain version for the codecs
    none, fp16 and int8, with the tensor-wide and the per-row int8 amax:
    the split path's (256, 12544), (256, 6272) and (256, 4096) crossings,
    ragged N, more rows than the card holds CTAs at once, rows too long to
    hold on chip, x 4 bytes off a 16-byte boundary, an all-zero tensor
    (int8 scale 1.0), noise 0 and > 0 with injected noise, one launch a
    call, and the qdq before the clip bit for bit; a NaN in both amax
    modes; then times at the main path's shapes."""
    from repro_torch.core.split import (CodecBoundaryStage,
                                        GaussianBoundaryStage)
    from repro_torch.fed.transport import make_codec
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.kernels.boundary_fuse.ref import (codec_qdq,
                                                       fused_boundary_ref)

    gen = torch.Generator(device=dev).manual_seed(3)
    main_shapes = ((BATCH, 6272), (BATCH, 4096))
    # (B, N, offset): offset floats into a larger buffer puts x that many
    # 4-byte steps off a 16-byte boundary
    shapes = [(b, n, 0) for b, n in main_shapes + (
        (BATCH, 12544), (BATCH, 1), (3, 4097), (BATCH, 4097),
        (4096, 64),                 # more rows than CTAs resident at once
        (4, 300_000))]              # rows longer than the on-chip limit
    shapes += [(BATCH, 6272, 1), (5, 999, 3)]
    max_abs, n_cases, calls = 0.0, 0, 0

    def launch(*args, **kw):
        nonlocal calls
        before = boundary_fuse_kernel.launches
        out = boundary_fuse_kernel(*args, **kw)
        check(boundary_fuse_kernel.launches == before + 1,
              "boundary_fuse did not launch exactly once")
        calls += 1
        return out

    for codec in ("none", "fp16", "int8"):
        for amax in ("tensor", "row"):
            for b, n, off in shapes:
                buf = torch.empty(b * n + off, device=dev)
                x = buf[off:].view(b, n)
                x.copy_(torch.randn((b, n), generator=gen, device=dev)
                        * torch.logspace(-3, -1, b, device=dev)[:, None])
                z = torch.randn((b, n), generator=gen, device=dev)
                for ns in (0.0, 0.5):
                    got = launch(x, 1.0, ns, z, codec=codec, amax=amax)
                    want = fused_boundary_ref(x, 1.0, ns, z, codec=codec,
                                              amax=amax)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, **KERNEL_TOL)
                    max_abs = max(max_abs, float((got - want).abs().max()))
                    n_cases += 1
                q = launch(x, 1e30, 0.0, z, codec=codec, amax=amax)
                check(torch.equal(q, codec_qdq(x, codec, amax)),
                      f"boundary_fuse {codec} amax={amax} qdq differs from "
                      f"the codec's at {(b, n)}, offset {off}")
            zero = torch.zeros(main_shapes[0], device=dev)
            check(torch.equal(launch(zero, 1.0, 0.0, zero, codec=codec,
                                     amax=amax), zero),
                  f"boundary_fuse {codec}: an all-zero tensor did not stay 0")
    # a NaN propagates as in the reference: the int8 scale 1.0 (for the
    # whole tensor, or in the row mode for its row alone), the NaN's whole
    # row NaN (its norm is NaN), every other element as the plain version
    x = torch.randn(main_shapes[0], generator=gen, device=dev) * 0.05
    z = torch.randn(main_shapes[0], generator=gen, device=dev)
    nan_row = main_shapes[0][0] // 3
    x[nan_row, 1234] = float("nan")
    for amax in ("tensor", "row"):
        for clip, ns in ((1e30, 0.0), (1.0, 0.5)):
            got = launch(x, clip, ns, z, codec="int8", amax=amax)
            want = fused_boundary_ref(x, clip, ns, z, codec="int8",
                                      amax=amax)
            torch.cuda.synchronize()
            check(torch.equal(torch.isnan(got), torch.isnan(want))
                  and bool(torch.isnan(want[nan_row]).all())
                  and int(torch.isnan(want).sum()) == want.shape[1],
                  f"boundary_fuse int8 amax={amax} with a NaN: NaN at other "
                  f"places than the plain version (clip {clip})")
            keep = ~torch.isnan(want)
            if clip == 1e30:
                check(torch.equal(got[keep], want[keep]),
                      f"boundary_fuse int8 amax={amax} with a NaN: the qdq "
                      f"differs")
            else:
                torch.testing.assert_close(got[keep], want[keep],
                                           **KERNEL_TOL)
    print(f"boundary_fuse vs plain: {n_cases} cases (codecs none/fp16/int8, "
          f"amax tensor/row, {[s[:2] for s in shapes]}, x 1 and 3 floats "
          f"off a 16-byte boundary), max abs err {max_abs:.3e} (tolerance "
          f"{KERNEL_TOL}); qdq before the clip equal bit for bit; all-zero "
          f"tensors stay 0; int8 with one NaN in {main_shapes[0]}, both "
          f"amax modes: NaN in the same places (its row), the qdq equal bit "
          f"for bit elsewhere; {calls} calls, 1 launch each")

    rows = {}
    for b, n in main_shapes:
        x = torch.randn((b, n), generator=gen, device=dev) * 0.05
        z = torch.randn((b, n), generator=gen, device=dev)
        codec, ns = "int8", 0.5
        qdq_stage = CodecBoundaryStage(make_codec(codec))
        clip_stage = GaussianBoundaryStage(1.0, 0.0)

        def unfused():
            # the composed int8 -> dp stage's own torch calls, fed the
            # same noise instead of drawing it
            return clip_stage.apply(qdq_stage.apply(x)) + ns * z

        t = time_variants({
            "kernel": lambda: boundary_fuse_kernel(x, 1.0, ns, z,
                                                   codec=codec),
            "row": lambda: boundary_fuse_kernel(x, 1.0, ns, z, codec=codec,
                                                amax="row"),
            "plain": lambda: fused_boundary_ref(x, 1.0, ns, z, codec=codec),
            "library": unfused})
        nbytes = 4 * 3 * b * n
        bound, by = bound_ms(nbytes, BOUNDARY_OPS[codec] * b * n)
        rows[(b, n)] = (t["device"], bound, by)
        print(f"boundary_fuse int8 ({b}, {n}): bound {bound:.4f} ms ({by}: "
              f"{nbytes} B at 3.35 TB/s)")
        for mode, tm in t.items():
            print(f"  {mode:6s} kernel {tm['kernel']:.4f} ms (amax=row "
                  f"{tm['row']:.4f}), plain {tm['plain']:.4f} ms, composed "
                  f"stages {tm['library']:.4f} ms")
    d, bound, by = rows[main_shapes[0]]
    return {"name": "boundary_fuse", "route": "cuda",
            "source": "src/repro_torch/csrc/boundary_fuse.cu",
            "replaces": "src/repro/kernels/boundary_fuse/kernel.py:84",
            "launches": None, "max_abs_err": max_abs,
            "ms": d["kernel"], "plain_ms": d["plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": d["library"]}


def encode_round(dev, codec_name, sizes, seed):
    """The wires a round's CLIENTS uplinks give the server reduce: each
    client's per-leaf delta (about the size of two Adam steps) through the
    codec, as ``Codec.encode`` makes them on the main path."""
    from repro_torch.fed.transport import make_codec
    gen = torch.Generator(device=dev).manual_seed(seed)
    codec = make_codec("none" if codec_name == "fp32" else codec_name)
    return [[codec.encode(torch.randn((n,), generator=gen, device=dev)
                          * 4e-4) for n in sizes] for _ in range(CLIENTS)]


def agg_case_rows(rounds, k):
    """Leaf ``k``'s (C, N) wire stack and (C,) scales from encoded rounds."""
    wires = torch.stack([c[k][0] for c in rounds])
    scales = (torch.stack([c[k][1] for c in rounds])
              if wires.dtype == torch.int8
              else torch.ones((len(rounds),), device=wires.device))
    return wires, scales


def phase_agg_fuse(dev):
    """The three agg_fuse kernels against their plain versions at the main
    path's shapes (every D leaf, C = 5; the whole D; int8, fp16 and fp32
    wires; top-k at 1%), at ragged sizes, with an all-zero int8 leaf and a
    scatter with colliding and out-of-range indices; then times of a
    round's work against the bound, the plain version and one library
    call."""
    from repro_torch.configs.registry import get_config
    from repro_torch.fed.transport import make_codec
    from repro_torch.kernels.agg_fuse.kernel import (
        MAX_LEAVES, dequant_acc_kernel, dequant_reduce_kernel,
        scatter_acc_kernel, scatter_acc_leaves_kernel)
    from repro_torch.kernels.agg_fuse.ops import scatter_acc_leaves
    from repro_torch.kernels.agg_fuse.ref import (dequant_acc_ref,
                                                  dequant_reduce_ref,
                                                  scatter_acc_ref)
    from repro_torch.models.dcgan import disc_init
    from repro_torch.tree import leaves

    c = get_config("dcgan-mnist").model.dcgan
    sizes = [l.numel() for l in leaves(disc_init(
        torch.Generator().manual_seed(0), c, "meta"))]
    gen = torch.Generator(device=dev).manual_seed(4)
    w = torch.rand((CLIENTS,), generator=gen, device=dev) + 0.5
    w = w / w.sum()
    w_host = [float(x) for x in w.cpu()]
    big = int(np.argmax(sizes))
    rounds = {d: encode_round(dev, d, sizes + [1, 4097, 5000], 10 + i)
              for i, d in enumerate(("int8", "fp16", "fp32", "topk"))}
    err = {"dequant_reduce": 0.0, "dequant_acc": 0.0, "scatter_acc": 0.0}
    n_cases = {k: 0 for k in err}

    def held(name, got, want, exact):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        check(not exact or torch.equal(got, want),
              f"{name} differs from its plain version bit for bit")
        err[name] = max(err[name], float((got - want).abs().max()))
        n_cases[name] += 1

    for d in ("int8", "fp16", "fp32"):
        rnd = rounds[d]
        stacks = [agg_case_rows(rnd, k) for k in range(len(rnd[0]))]
        whole = (torch.cat([x for x, _ in stacks[:len(sizes)]], dim=1),
                 stacks[0][1])
        for x, sc in stacks + [whole]:
            coefs = torch.stack([w, sc], dim=1)
            got = dequant_reduce_kernel(x, coefs)
            held("dequant_reduce", got, dequant_reduce_ref(x, coefs), False)
            check(torch.equal(got, dequant_reduce_kernel(x, coefs)),
                  f"dequant_reduce {d} is not deterministic")
        # the largest leaf and a whole round's 60 folds (5 clients x 12
        # leaves), then the ragged leaves
        for k in [big] + list(range(len(rnd[0]))):
            acc = torch.randn((rnd[0][k][0].numel(),), generator=gen,
                              device=dev)
            for ci, client in enumerate(rnd):
                wire, scale = client[k]
                want = dequant_acc_ref(acc, wire, w_host[ci],
                                       1.0 if scale is None else scale)
                acc = dequant_acc_kernel(acc, wire, w_host[ci], scale)
                held("dequant_acc", acc, want, True)
    zero_wire, zero_scale = make_codec("int8").encode(
        torch.zeros((sizes[big],), device=dev))
    check(float(zero_scale) == 1.0, "int8 scale of an all-zero leaf is not 1")
    zstack = zero_wire.expand(CLIENTS, -1).contiguous()
    check(torch.equal(dequant_reduce_kernel(zstack, torch.stack(
        [w, zero_scale.expand(CLIENTS)], dim=1)),
        torch.zeros((sizes[big],), device=dev)),
        "dequant_reduce of an all-zero int8 leaf is not 0")
    acc = torch.randn((sizes[big],), generator=gen, device=dev)
    check(torch.equal(dequant_acc_kernel(acc.clone(), zero_wire, 0.3,
                                         zero_scale), acc),
          "dequant_acc of an all-zero int8 leaf changed the accumulator")

    # top-k: K = 8192 distinct indices into conv2.w, every leaf, ragged
    # leaves (all distinct: equal to index_add bit for bit); then colliding
    # and out-of-range indices (atomic order varies: at tolerance)
    for k in [big] + list(range(len(rounds["topk"][0]))):
        acc = torch.randn((rounds["topk"][0][k][1][0],), generator=gen,
                          device=dev)
        for ci, client in enumerate(rounds["topk"]):
            (vals, idx), _ = client[k]
            want = scatter_acc_ref(acc, vals, idx, w_host[ci])
            acc = scatter_acc_kernel(acc, vals, idx, w_host[ci])
            held("scatter_acc", acc, want, True)
    for n in (sizes[big], 4097, 1):
        acc = torch.randn((n,), generator=gen, device=dev)
        idx = torch.randint(-3, n + 3, (8192,), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[:64] = n // 2                           # 64 adds to one element
        vals = torch.randn((8192,), generator=gen, device=dev)
        want = scatter_acc_ref(acc, vals, idx, 0.7)
        held("scatter_acc", scatter_acc_kernel(acc.clone(), vals, idx, 0.7),
             want, False)
    # a whole fold's leaves in one launch, as StreamingAggregator.fold
    # makes it, and a table of 72 leaves (the 15 above, repeated; two
    # launches); distinct indices in every leaf: bit for bit
    tables = []
    for ci, client in enumerate(rounds["topk"]):
        accs = [torch.randn((n,), generator=gen, device=dev)
                for n in sizes + [1, 4097, 5000]]
        tables.append((accs, [v for (v, _), _ in client],
                       [i for (_, i), _ in client], w_host[ci]))
    accs, vals, idxs, _ = tables[0]
    tables.append(([a.clone() for a in (accs * 5)[:72]], (vals * 5)[:72],
                   (idxs * 5)[:72], 0.3))
    for accs, vals, idxs, wc in tables:
        want = [scatter_acc_ref(a, v, i, wc)
                for a, v, i in zip(accs, vals, idxs)]
        before = scatter_acc_leaves_kernel.launches
        got = scatter_acc_leaves_kernel(accs, vals, idxs, wc)
        check(scatter_acc_leaves_kernel.launches - before
              == -(-len(accs) // MAX_LEAVES),
              f"scatter_acc over {len(accs)} leaves: "
              f"{scatter_acc_leaves_kernel.launches - before} launches")
        for g, wl in zip(got, want):
            held("scatter_acc", g, wl, True)
    print(f"agg_fuse vs plain: dequant_reduce {n_cases['dequant_reduce']} "
          f"cases (every D leaf, the whole D, N = 1, 4097, 5000; int8, fp16, "
          f"fp32), max abs err {err['dequant_reduce']:.3e} (tolerance "
          f"{KERNEL_TOL}), two launches equal bit for bit; dequant_acc "
          f"{n_cases['dequant_acc']} folds (largest leaf, a round's 60, "
          f"ragged; int8, fp16, fp32), equal bit for bit, max abs err "
          f"{err['dequant_acc']:.3e}; scatter_acc {n_cases['scatter_acc']} "
          f"leaf folds (K = 1% of each leaf, distinct: equal to index_add bit "
          f"for bit, one leaf a launch and a fold's 15 leaves a launch, 72 "
          f"leaves in two; colliding and out-of-range at tolerance), max abs "
          f"err "
          f"{err['scatter_acc']:.3e}; an all-zero int8 leaf (scale 1.0) "
          f"adds 0")

    rows = {}
    # row 4: a round's batched reduce, one launch a leaf
    for d in ("int8", "fp16", "fp32"):
        rnd = rounds[d]
        cases = [agg_case_rows(rnd, k) for k in range(len(sizes))]
        coefs = [torch.stack([w, sc], dim=1) for _, sc in cases]
        coef = [cf[:, 0] * cf[:, 1] for cf in coefs]
        xs = [x for x, _ in cases]
        t = time_variants({
            "kernel": lambda: [dequant_reduce_kernel(x, cf)
                               for x, cf in zip(xs, coefs)],
            "plain": lambda: [dequant_reduce_ref(x, cf)
                              for x, cf in zip(xs, coefs)],
            "library": lambda: [k @ x.to(torch.float32)
                                for k, x in zip(coef, xs)]})
        nbytes = sum(x.numel() * x.element_size() + 4 * x.shape[1]
                     + cf.numel() * 4 for x, cf in zip(xs, coefs))
        bound, by = bound_ms(nbytes, sum(2 * x.numel() for x in xs))
        rows[("dequant_reduce", d)] = (t["device"], bound, by)
        print(f"dequant_reduce {d}, a round (12 leaves, C = {CLIENTS}): "
              f"bound {bound:.5f} ms ({by}: {nbytes} B at 3.35 TB/s)")
        for mode, tm in t.items():
            print(f"  {mode:6s} kernel {tm['kernel']:.5f} ms, plain "
                  f"{tm['plain']:.5f} ms, cast + coef @ wires "
                  f"{tm['library']:.5f} ms")
    # row 5: a round's 60 streamed folds, in place
    for d in ("int8", "fp16"):
        rnd = rounds[d]
        accs = [torch.zeros((n,), device=dev) for n in sizes]
        folds = [(accs[k], client[k][0], w_host[ci], client[k][1],
                  w[ci] * (1.0 if client[k][1] is None else client[k][1]))
                 for ci, client in enumerate(rnd) for k in range(len(sizes))]
        t = time_variants({
            "kernel": lambda: [dequant_acc_kernel(a, x, wc, sc)
                               for a, x, wc, sc, _ in folds],
            "plain": lambda: [dequant_acc_ref(a, x, wc,
                                              1.0 if sc is None else sc)
                              for a, x, wc, sc, _ in folds],
            "library": lambda: [a.addcmul_(x.to(torch.float32), k)
                                for a, x, _, _, k in folds]})
        nbytes = sum(x.numel() * x.element_size() + 8 * x.numel()
                     + (0 if sc is None else 4) for _, x, _, sc, _ in folds)
        bound, by = bound_ms(nbytes, sum(2 * x.numel()
                                         for _, x, _, _, _ in folds))
        rows[("dequant_acc", d)] = (t["device"], bound, by)
        print(f"dequant_acc {d}, a round's {len(folds)} folds: bound "
              f"{bound:.5f} ms ({by}: {nbytes} B at 3.35 TB/s)")
        for mode, tm in t.items():
            print(f"  {mode:6s} kernel {tm['kernel']:.5f} ms, plain "
                  f"{tm['plain']:.5f} ms, cast + addcmul_ "
                  f"{tm['library']:.5f} ms")
    # row 6: a round's top-k folds, in place: one launch a client's fold
    # over its 12 leaves (the main path), beside one launch a leaf
    accs = [torch.zeros((n,), device=dev) for n in sizes]
    folds = [(accs, [client[k][0][0] for k in range(len(sizes))],
              [client[k][0][1] for k in range(len(sizes))], w_host[ci])
             for ci, client in enumerate(rounds["topk"])]
    leaf_folds = [(a, v, i, wc) for _, vs, ix, wc in folds
                  for a, v, i in zip(accs, vs, ix)]
    t = time_variants({
        "kernel": lambda: [scatter_acc_leaves_kernel(a, v, i, wc)
                           for a, v, i, wc in folds],
        "per_leaf": lambda: [scatter_acc_kernel(a, v, i, wc)
                             for a, v, i, wc in leaf_folds],
        "plain": lambda: [scatter_acc_leaves(a, v, i, wc)
                          for a, v, i, wc in folds],
        "library": lambda: [a.index_add_(0, i, v, alpha=wc)
                            for a, v, i, wc in leaf_folds]})
    kept = sum(v.numel() for _, v, _, _ in leaf_folds)
    nbytes = 16 * kept
    bound, by = bound_ms(nbytes, 2 * kept)
    rows[("scatter_acc", "topk")] = (t["device"], bound, by)
    print(f"scatter_acc, a round's {len(folds)} top-k folds of "
          f"{len(sizes)} leaves ({kept} kept entries): bound {bound:.6f} ms "
          f"({by}: {nbytes} B at 3.35 TB/s)")
    for mode, tm in t.items():
        print(f"  {mode:6s} kernel {tm['kernel']:.5f} ms ({len(folds)} "
              f"launches; one a leaf: {tm['per_leaf']:.5f} ms, "
              f"{len(leaf_folds)} launches), plain {tm['plain']:.5f} ms, "
              f"index_add_ {tm['library']:.5f} ms")

    def row(name, key, line):
        d, bound, by = rows[key]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/agg_fuse.cu",
                "replaces": f"src/repro/kernels/agg_fuse/kernel.py:{line}",
                "launches": None, "max_abs_err": err[name],
                "ms": d["kernel"], "plain_ms": d["plain"], "bound_ms": bound,
                "bound_by": by, "library_ms": d["library"]}

    return [row("dequant_reduce", ("dequant_reduce", "int8"), 61),
            row("dequant_acc", ("dequant_acc", "int8"), 91),
            row("scatter_acc", ("scatter_acc", "topk"), 133)]


AGG_KERNELS = {"dequant_reduce", "dequant_acc", "scatter_acc"}


def kernel_wrappers():
    from repro_torch.kernels.agg_fuse.kernel import (
        dequant_acc_kernel, dequant_reduce_kernel, scatter_acc_leaves_kernel)
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
    from repro_torch.kernels.fedavg.kernel import fedavg_kernel
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.wkv6.kernel import wkv6_kernel
    return {"fedavg": fedavg_kernel, "dp_clip": dp_clip_noise_kernel,
            "boundary_fuse": boundary_fuse_kernel,
            "dequant_reduce": dequant_reduce_kernel,
            "dequant_acc": dequant_acc_kernel,
            "scatter_acc": scatter_acc_leaves_kernel,
            "flash_attention": flash_attention_kernel,
            "wkv6": wkv6_kernel}


def drive_path(dev, label, over, parts, expect):
    """One main path: ``train_epoch`` at full width, ROUNDS x BATCHES, with
    every kernel's launch count set to 0 just before and read just after.
    Checks finite losses, every parameter finite on the card, and each
    kernel's launches: ``expect[name]`` for the kernels the path runs, 0
    for every other (``expect`` may be a function of the trainer)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gan import FSLGANTrainer
    from repro_torch.tree import leaves

    cfg = get_config("dcgan-mnist").override(
        {"fed.kernel_aggregation": True, **over})
    c = cfg.model.dcgan
    check((cfg.fsl.num_clients, cfg.shape.global_batch, c.base_filters,
           c.latent_dim, cfg.optim.lr) == (CLIENTS, BATCH, 64, 100, 2e-4),
          "dcgan-mnist is not at full width")
    tr = FSLGANTrainer(cfg, parts, seed=0)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    hist = []
    for r in range(ROUNDS):
        t0 = time.perf_counter()
        m = tr.train_epoch(batches_per_client=BATCHES)
        torch.cuda.synchronize()
        hist.append(m)
        extra = "".join(f", {k} {m[k]:.6g}" for k in (
            "dp_epsilon", "lan_mbytes", "edge_mbytes", "codec_error")
            if k in m)
        print(f"{label} round {r}: wall {time.perf_counter() - t0:.3f} s, "
              f"d_loss {m['d_loss']:.6f}, g_loss {m['g_loss']:.6f}, clients "
              f"{m['num_clients']:.0f}, virtual round "
              f"{m['round_time_s']:.1f} s, up {m['up_mbytes']:.3f} MB{extra}")
    counts = {k: w.launches for k, w in wrappers.items()}
    for m in hist:
        check(math.isfinite(m["d_loss"]) and math.isfinite(m["g_loss"]),
              f"{label}: non-finite loss {m}")
        check(m["num_clients"] == CLIENTS, f"{label}: clients dropped: {m}")
    st = tr.state
    for t in [st.g_params, st.g_opt] + list(st.d_params.values()) \
            + list(st.d_opt.values()):
        for leaf in leaves(t):
            check(leaf.device.type == "cuda",
                  f"{label}: a parameter on {leaf.device}")
            check(bool(torch.isfinite(leaf.float()).all()),
                  f"{label}: non-finite parameter")
    if callable(expect):
        expect = expect(tr)
    want = {k: expect.get(k, 0) for k in counts}
    check(counts == want, f"{label}: kernel launches {counts}, expected "
          f"{want}")
    print(f"{label}: {ROUNDS} rounds x {BATCHES} batches x {CLIENTS} "
          f"clients, launches {counts} as expected, peak_live_trees "
          f"{tr.engine.last_report.peak_live_trees}, parameters finite on "
          f"{dev}")
    return tr, hist, counts


def phase_main_paths(dev):
    from repro_torch.configs.registry import get_config
    from repro_torch.data import partition_dirichlet, synthetic_mnist
    from repro_torch.fed.transport import predict_codec_bytes
    from repro_torch.models.dcgan import disc_init
    from repro_torch.tree import leaves

    # the paper's 24 batches x 256 examples per client
    imgs, labels = synthetic_mnist(24 * BATCH * CLIENTS, seed=0)
    parts = partition_dirichlet(imgs, labels, CLIENTS, alpha=0.5, seed=0)
    sizes = [l.numel() for l in leaves(disc_init(
        torch.Generator().manual_seed(0),
        get_config("dcgan-mnist").model.dcgan, "meta"))]
    n_leaves = len(sizes)
    reduce_round = n_leaves * ROUNDS                  # one launch a leaf
    folds = CLIENTS * n_leaves * ROUNDS               # one a client x leaf
    launches = {}

    tr, _, counts = drive_path(dev, "main path", {}, parts,
                               {"fedavg": reduce_round})
    launches["fedavg"] = counts["fedavg"]
    img = tr.generate(16)
    check(img.shape == (16, 28, 28, 1) and np.isfinite(img).all()
          and np.abs(img).max() <= 1.0, "generated images out of shape/range")

    tr, hist, _ = drive_path(
        dev, "dp-sgd path", DP_SGD, parts,
        {"fedavg": reduce_round, "dp_clip": CLIENTS * BATCHES * ROUNDS})
    eps = [m["dp_epsilon"] for m in hist]
    check(all(math.isfinite(e) for e in eps) and eps[1] > eps[0] > 0,
          f"dp_epsilon not finite and growing: {eps}")
    launches["dp_clip"] = CLIENTS * BATCHES * ROUNDS

    def split_launches(tr):
        # 4 crossings a boundary a batch: the real and fake passes, forward
        # and backward
        return {"fedavg": reduce_round, "boundary_fuse": sum(
            4 * ex.num_boundaries * BATCHES * ROUNDS
            for ex in tr.split_execs.values())}

    tr, hist, counts = drive_path(dev, "split path", SPLIT, parts,
                                  split_launches)
    bounds = sum(ex.num_boundaries for ex in tr.split_execs.values())
    want = counts["boundary_fuse"]
    x_shape = (BATCH, 28, 28, 1)
    lan = sum(BATCHES * ex.step_wire_bytes(tr.state.d_params[cid],
                                           x_shape)[0]
              for cid, ex in tr.split_execs.items())
    for m in hist:
        check(m["lan_mbytes"] == lan / 1e6,
              f"lan_mbytes {m['lan_mbytes']} != step_wire_bytes {lan / 1e6}")
    print(f"split path: {bounds} boundaries over {CLIENTS} clients, "
          f"boundary_fuse 4 x {bounds} x {BATCHES} x {ROUNDS} = {want}, "
          f"lan_mbytes {lan / 1e6} as step_wire_bytes predicts")
    launches["boundary_fuse"] = want

    # the compressed-domain server reduce: the fedavg kernel does not run
    # on the flat paths; every client's wire folds leaf by leaf
    int8 = {"fed.codec": "int8"}
    for label, over, expect in (
            ("stream int8 path", {**int8, "fed.server_reduce": "stream"},
             {"dequant_acc": folds}),
            ("batched int8 path", {**int8, "fed.server_reduce": "batched"},
             {"dequant_reduce": reduce_round}),
            ("stream top-k path", {"fed.codec": "topk",
                                   "fed.server_reduce": "stream"},
             {"scatter_acc": CLIENTS * ROUNDS})):       # one a fold
        tr, hist, _ = drive_path(dev, label, over, parts, expect)
        check(tr.engine.last_report.peak_live_trees == 1,
              f"{label}: peak_live_trees "
              f"{tr.engine.last_report.peak_live_trees}, expected 1")
        check(all(0.0 < m["codec_error"] < 1.0 for m in hist),
              f"{label}: codec_error out of range")
        launches.update(expect)

    # the edge hierarchy: cohorts of 3 and 2 clients fold their int8 wires
    # at the edge, the server averages the 2 cohort aggregates (fedavg)
    tr, hist, _ = drive_path(
        dev, "hierarchy stream path",
        {**int8, "fed.server_reduce": "stream", "fed.hierarchy_cohorts": 2},
        parts, {"dequant_acc": folds, "fedavg": reduce_round})
    groups = tr.engine.hierarchy.group(tr.engine.roster)
    cohort_sizes = sorted(len(m) for m in groups.values())
    check(cohort_sizes == [2, 3], f"cohorts {groups}")
    check(tr.engine.last_report.peak_live_trees == 3,
          f"hierarchy: peak_live_trees "
          f"{tr.engine.last_report.peak_live_trees}, expected 3")
    edge = CLIENTS * predict_codec_bytes("int8", sizes) / 1e6
    up = 2 * 4 * sum(sizes) / 1e6
    for m in hist:
        check(m["edge_mbytes"] == edge and m["up_mbytes"] == up,
              f"hierarchy bytes: edge {m['edge_mbytes']} (expected {edge}),"
              f" up {m['up_mbytes']} (expected {up})")
    print(f"hierarchy stream path: cohorts {cohort_sizes}, edge_mbytes "
          f"{edge} = {CLIENTS} x the int8 "
          f"wire, up_mbytes {up} = 2 cohorts x 4 x {sum(sizes)} B")
    return launches


def compare_states(label, ta, tb, start):
    """G and client 0's D of two small trainers that took the same steps
    from the same ``start`` leaves: every leaf within 1e-4 absolute, except
    the BN-fed biases, which must each stay within lr x Adam steps of their
    start."""
    from repro_torch.tree import leaves
    drift = ta.cfg.optim.lr * ROUNDS * BATCHES
    worst = 0.0
    start = list(start)
    for tree_a, tree_b in ((ta.state.g_params, tb.state.g_params),
                           (ta.state.d_params["c0"], tb.state.d_params["c0"])):
        for p, a, b in zip(paths(tree_a), leaves(tree_a), leaves(tree_b)):
            s = start.pop(0)
            if p[-2:] in BN_FED_BIASES:
                for side in (a, b):
                    check(float((side - s).abs().max()) <= drift,
                          f"{label}: {p} drifted beyond lr x steps")
            else:
                d = float((a - b).abs().max())
                worst = max(worst, d)
                check(d <= 1e-4, f"{label}: {p} differs by {d}")
    return worst


def small_trainer(over):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gan import FSLGANTrainer
    from repro_torch.data import partition_dirichlet, synthetic_mnist

    small = {"shape.global_batch": 8, "fsl.num_clients": 2,
             "model.dcgan.base_filters": 8}
    imgs, labels = synthetic_mnist(120, seed=0)
    parts = partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)
    return FSLGANTrainer(get_config("dcgan-mnist").override(
        {**small, **over}), parts, seed=0)


def phase_small_reference(dev):
    """On the card at a small width: the kernel round against the
    sequential round with the host FedAvg; the DP-SGD engine round
    (dp_clip kernel, noise off) against the sequential DP round; the
    identity-stage split round against the unsplit round; one uplink-DP
    round with the int8 codec; the stream and batched reduce against the
    decode reduce, flat, through the hierarchy and in the async modes."""
    from repro_torch.fed.transport import predict_codec_bytes
    from repro_torch.tree import leaves

    def pair(label, over_a, over_b, run_b="train_epoch_sequential"):
        ta, tb = small_trainer(over_a), small_trainer(over_b)
        start = [t.clone() for t in leaves(ta.state.g_params)
                 + leaves(ta.state.d_params["c0"])]
        for _ in range(ROUNDS):
            ma = ta.train_epoch(batches_per_client=BATCHES)
            mb = getattr(tb, run_b)(batches_per_client=BATCHES)
            for k in ("d_loss", "g_loss"):
                check(abs(ma[k] - mb[k]) <= 1e-4 * abs(mb[k]),
                      f"{label}: {k} {ma[k]} vs {mb[k]}")
        worst = compare_states(label, ta, tb, start)
        print(f"small input, {label}: losses within 1e-4 rel, params max "
              f"abs diff {worst:.3e}")

    pair("kernel round vs sequential host-FedAvg round",
         {"fed.kernel_aggregation": True}, {})
    dp0 = {**DP_SGD, "privacy.noise_multiplier": 0.0,
           "privacy.clip_norm": 0.1}
    pair("dp-sgd engine round vs sequential dp-sgd round (noise 0)", dp0,
         dp0)
    pair("identity-stage split round vs unsplit round",
         {"split.enabled": True}, {}, run_b="train_epoch")
    # the same pair with cuDNN's deterministic algorithms: the drift above
    # is the convolutions' summation order, not the split (on an H100
    # 80GB HBM3 at 700 W the pair is bit-exact this way), so it is held
    # to 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ta = small_trainer({"split.enabled": True})
        tb = small_trainer({})
        for _ in range(ROUNDS):
            ta.train_epoch(batches_per_client=BATCHES)
            tb.train_epoch(batches_per_client=BATCHES)
        trees = [(ta.state.g_params, tb.state.g_params)] + [
            (ta.state.d_params[c], tb.state.d_params[c])
            for c in sorted(ta.state.d_params)]
        split_diff, split_at = max(
            (float((a - b).abs().max()), p) for ta_, tb_ in trees
            for p, a, b in zip(paths(ta_), leaves(ta_), leaves(tb_)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"small input, identity-stage split round vs unsplit round under "
          f"deterministic cuDNN: every leaf of G and of each client's D, "
          f"max abs diff {split_diff:.3e} (at {split_at})")
    check(split_diff == 0.0, f"identity split vs unsplit under "
          f"deterministic cuDNN: {split_diff} at {split_at}")

    tr = small_trainer({"privacy.enabled": True, "privacy.mode": "uplink",
                        "privacy.clip_norm": 0.01,
                        "privacy.noise_multiplier": 1.0, "fed.codec": "int8"})
    before = {k: w.launches for k, w in kernel_wrappers().items()}
    m = tr.train_epoch(batches_per_client=BATCHES)
    after = {k: w.launches for k, w in kernel_wrappers().items()}
    sizes = [l.numel() for l in leaves(tr.state.d_params["c0"])]
    check(before == after, f"the uplink-DP round launched a kernel: {after}")
    check(m["up_mbytes"] == 2 * predict_codec_bytes("int8", sizes) / 1e6,
          f"uplink int8 bytes {m['up_mbytes']}")
    check(0.0 < m["codec_error"] < 0.1 and math.isfinite(m["dp_epsilon"])
          and math.isfinite(m["d_loss"]), f"uplink-DP round: {m}")
    print(f"small input, uplink DP + int8 round: up {m['up_mbytes']} MB, "
          f"codec error {m['codec_error']:.3e}, epsilon "
          f"{m['dp_epsilon']:.3f}, no kernel launched")

    # the compressed-domain reduce against decode, one round from the same
    # start, kernels on: the aggregated D within 2e-5 (the reference's own
    # pin, tests/test_agg_stream.py), wire bytes equal exactly.  The pin
    # holds the server reduce, so both trainers must train their clients
    # alike: cuDNN's default convolution algorithms may sum in another
    # order from one call to the next, and Adam turns the BN-fed biases'
    # rounding-level gradients into steps of about lr (on an H100, two
    # decode trainers with the same seed parted by 8.1e-5 after one round
    # without deterministic cuDNN)
    def against_decode(label, over, reduces, agg_kernels):
        base = {"fed.kernel_aggregation": True, **over}
        ta = small_trainer(base)
        ma = ta.train_epoch(batches_per_client=BATCHES)
        for reduce in reduces:
            tb = small_trainer({**base, "fed.server_reduce": reduce})
            before = {k: w.launches for k, w in kernel_wrappers().items()}
            mb = tb.train_epoch(batches_per_client=BATCHES)
            after = {k: w.launches for k, w in kernel_wrappers().items()}
            ran = {k for k in after if after[k] != before[k]}
            check(ran & AGG_KERNELS == agg_kernels.get(reduce, set()),
                  f"{label} {reduce}: kernels launched {ran}")
            worst, where = max(
                (float((a - b).abs().max()), p) for p, a, b in zip(
                    paths(ta.state.d_params["c0"]),
                    leaves(ta.state.d_params["c0"]),
                    leaves(tb.state.d_params["c0"])))
            check(worst <= 2e-5,
                  f"{label} {reduce}: D differs by {worst} at {where}")
            for k in ("up_mbytes", "edge_mbytes"):
                check(ma.get(k) == mb.get(k),
                      f"{label} {reduce}: {k} {mb.get(k)} vs {ma.get(k)}")
            print(f"small input, {label}, {reduce} vs decode: D max abs diff "
                  f"{worst:.3e}, up_mbytes {mb['up_mbytes']}, edge_mbytes "
                  f"{mb.get('edge_mbytes')}, agg_fuse kernels "
                  f"{sorted(ran & AGG_KERNELS)}")

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for codec in ("int8", "topk"):
        kern = ("scatter_acc" if codec == "topk" else "dequant_acc")
        against_decode(f"flat {codec}", {"fed.codec": codec},
                       ("stream", "batched"),
                       {"stream": {kern}, "batched": set()
                        if codec == "topk" else {"dequant_reduce"}})
    against_decode("hierarchy int8", {"fed.codec": "int8",
                                      "fed.hierarchy_cohorts": 2},
                   ("stream",), {"stream": {"dequant_acc"}})
    for mode in ("fedasync", "fedbuff"):
        against_decode(f"{mode} int8", {"fed.codec": "int8",
                                        "fed.mode": mode}, ("stream",), {})
    torch.backends.cudnn.deterministic = deterministic


# ---------------------------------------------------------------------------
# the LM substrate: flash_attention and wkv6
# ---------------------------------------------------------------------------

# the cases of tests/test_kernels.py: (b, sq, sk, h, hkv, d, causal, window)
FLASH_CASES = [(2, 128, 128, 4, 4, 64, True, 0), (1, 256, 256, 4, 2, 64, True, 0),
               (2, 200, 200, 4, 1, 128, True, 0), (1, 256, 256, 2, 2, 64, True, 64),
               (1, 384, 384, 8, 8, 32, True, 0), (1, 1, 384, 4, 2, 64, False, 0),
               (3, 64, 64, 2, 2, 64, True, 0)]
# (b, t, h, n)
WKV_CASES = [(2, 64, 2, 32), (1, 100, 4, 64), (2, 17, 1, 16), (1, 128, 2, 8)]
QWEN_FWD = (2, 2048)            # lm_loss batch x sequence on qwen3-14b
RWKV_FWD = (4, 2048)            # and on rwkv6-1.6b
SERVE_REQUESTS, SERVE_TOKENS = 4, 16
# |rwkv6-1.6b loss through the wkv6 kernel - through the plain scan| at
# full depth: the two sum in different orders, and 24 layers of bf16
# compute carry that into the loss.  Measured on an H100 80GB HBM3 at
# 700 W (PERF.md §6): 9.6e-04 for this kernel, 2.1e-03 for the design
# it replaced; the limit holds both with room.
RWKV_PLAIN_LOSS_TOL = 4e-3
# the bf16 tensor-core peak (NVIDIA data sheet, H100 SXM, dense)
BF16_FLOPS = 989e12
# flash kernel vs plain: fp32 sums of up to 2048 terms in another order;
# bf16: both round their fp32 result once, so they differ by at most one
# bf16 ulp (2^-7 relative) where the fp32 results straddle a rounding point
FLASH_TOL = {torch.float32: dict(rtol=0, atol=2e-5),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
# wkv6 kernel vs plain: fp32 sums over N in another order, carried through
# up to 2048 decaying steps (the reference's own kernel tests use 1e-4)
WKV_TOL = dict(rtol=1e-5, atol=1e-4)


def causal_pairs(s, window=0):
    """Unmasked (query, key) pairs of causal self-attention over s
    positions, banded to ``window`` when it is > 0."""
    qp = np.arange(s)
    lo = np.maximum(qp - window + 1, 0) if window else 0
    return int((qp - lo + 1).sum())


def phase_flash_attention(dev):
    """The flash_attention kernel against its plain version: the qwen3-14b
    forward's (2, 2048) x 40 heads / 8 kv heads x 128 in bf16 and fp32,
    causal and with a 512 window; the seven cases of the reference's
    kernel tests in both types; Sq < Sk with q_offset; a padded kv whose
    valid length leaves rows fully masked; Sq and Sk that are no multiple
    of the tiles; a contiguous (B, H, S, D) layout; head_dim 256 (bf16 on
    the CUDA cores) at the main path's sequence.  A bf16 view whose
    strides TMA cannot take must raise at the kernel; the op takes it
    (copied), and takes head_dim 16, 48, 80, 96 (zero-padded).  Then times
    at the main path's shape and at head_dim 256 beside SDPA, which the
    port never calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel, smem_bytes
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    # registers and spills from ptxas, shared memory (dynamic) by query
    for line in build.build_log("flash_attention").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kernel = "tensor cores" if "flash_fwd_tc" in name else "CUDA cores"
            dt = (torch.bfloat16 if "flash_fwd_tc" in name
                  or "bfloat16" in name else torch.float32)
            d = int(re.search(r"Li(\d+)E", name).group(1))
        elif "registers" in line or "spill" in line:
            print(f"flash_attention {dt} D {d} ({kernel}): {line.strip()}"
                  + (f"; {smem_bytes(dt, d)} B dynamic shared memory"
                     if "registers" in line else ""))

    gen = torch.Generator(device=dev).manual_seed(5)

    def qkv(b, sq, sk, h, hkv, d, dtype, bshd=True):
        # model layout (B, S, H, D), read through (B, H, S, D) views; or
        # a contiguous (B, H, S, D) tensor
        if not bshd:
            return tuple(torch.randn(shape, generator=gen, device=dev)
                         .to(dtype) for shape in
                         ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     .transpose(1, 2) for shape in
                     ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))

    main_shape = (QWEN_FWD[0], QWEN_FWD[1], QWEN_FWD[1], 40, 8, 128)
    d256_shape = (QWEN_FWD[0], QWEN_FWD[1], QWEN_FWD[1], 8, 8, 256)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        cases += [("main", main_shape, dict(causal=True), dt),
                  ("main window 512", main_shape,
                   dict(causal=True, window=512), dt),
                  ("D 256", d256_shape, dict(causal=True), dt),
                  ("D 256 window 512", d256_shape,
                   dict(causal=True, window=512), dt)]
        cases += [(f"reference {c}", c[:6], dict(causal=c[6], window=c[7]),
                   dt) for c in FLASH_CASES]
        cases += [("q_offset", (1, 100, 300, 8, 2, 128),
                   dict(causal=True, q_offset=200), dt),
                  ("fully masked rows", (2, 70, 150, 4, 2, 64),
                   dict(causal=True, window=16, q_offset=100,
                        seq_k_valid=100), dt),
                  ("ragged tiles", (2, 130, 190, 4, 2, 128),
                   dict(causal=True), dt),
                  ("ragged tiles, not causal", (2, 130, 190, 4, 2, 64),
                   dict(causal=False), dt),
                  ("(B, H, S, D) layout", (2, 200, 200, 8, 2, 128),
                   dict(causal=True, bshd=False), dt)]
    err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for label, shape, kw, dt in cases:
        kw = dict(kw)
        q, k, v = qkv(*shape, dt, bshd=kw.pop("bshd", True))
        got = flash_attention_kernel(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(got.dtype == dt and got.shape == want.shape,
              f"flash {label}: {got.dtype} {tuple(got.shape)}")
        try:
            torch.testing.assert_close(got, want, **FLASH_TOL[dt])
        except AssertionError as e:
            raise RuntimeError(f"flash_attention {label} {dt}: {e}") from None
        err[dt] = max(err[dt], float((got.float() - want.float()).abs().max()))
    print(f"flash_attention vs plain: {len(cases)} cases, max abs err "
          f"bf16 {err[torch.bfloat16]:.3e} (tolerance "
          f"{FLASH_TOL[torch.bfloat16]}), fp32 {err[torch.float32]:.3e} "
          f"(tolerance {FLASH_TOL[torch.float32]})")
    q, k, v = qkv(1, 16, 16, 2, 2, 64, torch.bfloat16)
    before = flash_attention_kernel.launches
    for label, bad in (("a 136-byte head stride", torch.randn(
            1, 16, 2, 68, device=dev).to(torch.bfloat16)[..., :64]),
                       ("an address off by 2 bytes", torch.randn(
            2049, device=dev).to(torch.bfloat16)[1:].view(1, 16, 2, 64))):
        try:
            flash_attention_kernel(bad.transpose(1, 2), k, v)
        except ValueError:
            continue
        raise RuntimeError(f"flash_attention: bf16 q with {label} ran")
    check(flash_attention_kernel.launches == before,
          "flash_attention launched on a view TMA cannot take")
    print("flash_attention: bf16 views TMA cannot take (a 136-byte head "
          "stride, an address off by 2 bytes) raise ValueError")

    # the op: head_dims the kernel is not built for (zero-padded to the
    # next one, the original scale), and the views above (copied)
    op_err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    op_cases = 0
    for d in (16, 48, 80, 96, 256):
        for dt in (torch.bfloat16, torch.float32):
            for window in (0, 64):
                q, k, v = (t.transpose(1, 2) for t in qkv(
                    2, 300, 300, 8, 2, d, dt))
                before = flash_attention_kernel.launches
                got = flash_attention(q, k, v, causal=True, window=window)
                want = attention_ref(
                    *(t.transpose(1, 2) for t in (q, k, v)),
                    window=window).transpose(1, 2)
                torch.cuda.synchronize()
                check(flash_attention_kernel.launches == before + 1
                      and got.shape == q.shape and got.dtype == dt,
                      f"flash op D {d} {dt}: {tuple(got.shape)}")
                try:
                    torch.testing.assert_close(got, want, **FLASH_TOL[dt])
                except AssertionError as e:
                    raise RuntimeError(f"flash op D {d} {dt} window "
                                       f"{window}: {e}") from None
                op_err[dt] = max(op_err[dt], float(
                    (got.float() - want.float()).abs().max()))
                op_cases += 1
    k, v = (torch.randn((1, 16, 2, 64), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    for label, bad in (("a 136-byte head stride", torch.randn(
            1, 16, 2, 68, device=dev).to(torch.bfloat16)[..., :64]),
                       ("an address off by 2 bytes", torch.randn(
            2049, device=dev).to(torch.bfloat16)[1:].view(1, 16, 2, 64))):
        got = flash_attention(bad, k, v)
        want = attention_ref(*(t.transpose(1, 2) for t in (bad, k, v))
                             ).transpose(1, 2)
        torch.testing.assert_close(got, want, **FLASH_TOL[torch.bfloat16])
        op_cases += 1
    print(f"flash_attention op: {op_cases} cases (head_dim 16, 48, 80, 96 "
          f"padded to 32 / 64 / 128 / 128, 256 as it is; causal and window "
          f"64; both bf16 views above, copied by the op), max abs err bf16 "
          f"{op_err[torch.bfloat16]:.3e}, fp32 {op_err[torch.float32]:.3e}")

    rows = {}
    for label, dt, window, shape in (
            ("bf16 causal", torch.bfloat16, 0, main_shape),
            ("bf16 window 512", torch.bfloat16, 512, main_shape),
            ("fp32 causal", torch.float32, 0, main_shape),
            ("bf16 D 256 causal", torch.bfloat16, 0, d256_shape),
            ("fp32 D 256 causal", torch.float32, 0, d256_shape)):
        q, k, v = qkv(*shape, dt)
        variants = {
            "kernel": lambda: flash_attention_kernel(q, k, v, causal=True,
                                                     window=window),
            "plain": lambda: attention_ref(q, k, v, causal=True,
                                           window=window)}
        if not window:
            variants["library"] = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        t = time_variants(variants, iters=10, reps=3)
        b, sq, sk, h, hkv, d = shape
        pairs = causal_pairs(sq, window)
        flops = 4 * b * h * d * pairs
        nbytes = q.element_size() * (2 * b * sq * h * d + 2 * b * sk * hkv * d)
        peak = BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS
        t_b, t_o = nbytes / HBM_BPS, flops / peak
        bound, by = 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o
                                          else "operations")
        rows[label] = (t["device"], bound, by)
        # bf16: P.V runs twice (P's bf16 high part and residual), so the
        # kernel's own tensor-core work is 1.5x the function's
        split = (f"; the kernel's 1.5x with P split: {1.5e3 * t_o:.4f} ms"
                 if dt == torch.bfloat16 and d <= 128 else "")
        print(f"flash_attention {label} {shape}: bound {bound:.4f} ms, "
              f"set by {by} ({flops:.4g} flops at {peak / 1e12:.0f} "
              f"TFLOP/s = {1e3 * t_o:.4f} ms{split}; {nbytes} B at 3.35 "
              f"TB/s = {1e3 * t_b:.4f} ms)")
        for mode, tm in t.items():
            lib = (f", SDPA {tm['library']:.4f} ms" if "library" in tm
                   else "")
            print(f"  {mode:6s} kernel {tm['kernel']:.4f} ms, plain "
                  f"{tm['plain']:.4f} ms{lib}")
    d, bound, by = rows["bf16 causal"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:91",
            "launches": None, "max_abs_err": max(err.values()),
            "ms": d["kernel"], "plain_ms": d["plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": d["library"]}


def phase_wkv6(dev):
    """The wkv6 kernel against its plain version: the rwkv6-1.6b forward's
    (4, 2048, 32, 64) with a random state0 and with none; the four cases of
    the reference's kernel tests; every N at T = 257 (past a chunk edge),
    with aligned and unaligned inputs; two halves chained through the
    state equal to one pass.  Then times at the main path's shape; no single
    PyTorch call computes the recurrence."""
    from repro_torch.kernels.wkv6.kernel import wkv6_kernel
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    gen = torch.Generator(device=dev).manual_seed(6)

    def inputs(b, t, h, n, state=True):
        r, k, v = (torch.randn((b, t, h, n), generator=gen, device=dev)
                   for _ in range(3))
        w = torch.exp(-torch.exp(0.5 * torch.randn(
            (b, t, h, n), generator=gen, device=dev)))
        u = 0.1 * torch.randn((h, n), generator=gen, device=dev)
        s0 = (0.1 * torch.randn((b, h, n, n), generator=gen, device=dev)
              if state else None)
        return r, k, v, w, u, s0

    main_shape = (RWKV_FWD[0], RWKV_FWD[1], 32, 64)
    cases = [("main, state0", inputs(*main_shape)),
             ("main, no state0", inputs(*main_shape, state=False))]
    cases += [(f"reference {c}", inputs(*c)) for c in WKV_CASES]
    for n in (8, 16, 32, 64):
        # T past a chunk edge (2048 / N steps); inputs 4 bytes off a
        # 16-byte boundary take the 4-byte copies
        args = inputs(2, 257, 3, n)
        cases.append((f"N {n}, T 257", args))
        off = [torch.empty(a.numel() + 1, device=dev)[1:].view(a.shape)
               .copy_(a) for a in args[:4]]
        cases.append((f"N {n}, T 257, unaligned", (*off, *args[4:])))
    max_abs = 0.0
    for label, args in cases:
        got = wkv6_kernel(*args)
        want = wkv6_ref(*args)
        torch.cuda.synchronize()
        for g, w_, what in zip(got, want, ("out", "state")):
            try:
                torch.testing.assert_close(g, w_, **WKV_TOL)
            except AssertionError as e:
                raise RuntimeError(f"wkv6 {label} {what}: {e}") from None
            max_abs = max(max_abs, float((g - w_).abs().max()))
    r, k, v, w, u, s0 = inputs(2, 300, 4, 64)
    full, sT = wkv6_kernel(r, k, v, w, u, s0)
    h1, s1 = wkv6_kernel(*(a[:, :137].contiguous() for a in (r, k, v, w)),
                         u, s0)
    h2, s2 = wkv6_kernel(*(a[:, 137:].contiguous() for a in (r, k, v, w)),
                         u, s1)
    torch.cuda.synchronize()
    check(torch.equal(torch.cat([h1, h2], 1), full) and torch.equal(s2, sT),
          "wkv6: two chained halves differ from one pass")
    print(f"wkv6 vs plain: {len(cases)} cases, max abs err {max_abs:.3e} "
          f"(tolerance {WKV_TOL}); two halves chained through the state "
          f"equal one pass bit for bit")

    args = inputs(*main_shape)
    t = time_variants({"kernel": lambda: wkv6_kernel(*args),
                       "plain": lambda: wkv6_ref(*args)}, iters=3, reps=1)
    b, t_, h, n = main_shape
    nbytes = 4 * (5 * b * t_ * h * n + h * n + 2 * b * h * n * n)
    flops = 7 * b * t_ * h * n * n
    bound, by = bound_ms(nbytes, flops)
    print(f"wkv6 {main_shape}: bound {bound:.4f} ms, set by {by} ({nbytes} "
          f"B at 3.35 TB/s = {1e3 * nbytes / HBM_BPS:.4f} ms; {flops:.4g} fp32 "
          f"flops at 67 TFLOP/s = {1e3 * flops / FP32_FLOPS:.4f} ms); "
          f"{t_} dependent steps on {b * h} chains")
    for mode, tm in t.items():
        print(f"  {mode:6s} kernel {tm['kernel']:.4f} ms, plain "
              f"{tm['plain']:.4f} ms ({tm['kernel'] * 1e3 / t_:.3f} us a "
              f"step)")
    d = t["device"]
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6/kernel.py:64",
            "launches": None, "max_abs_err": max_abs,
            "ms": d["kernel"], "plain_ms": d["plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def drive_lm(dev, arch, fwd_shape, kernel, full_width, plain_tol=None):
    """One LM at full width: ``lm_loss`` forward under ``torch.no_grad``
    with ``parallel.use_flash_kernel`` on a synthetic batch, then
    ``serve_batch`` (4 requests of 128-1024 prompt tokens, 16 greedy
    tokens, bf16 cache).  Every kernel's launch count is set to 0 just
    before each of the two and read just after: the forward must launch
    ``kernel`` once a layer and nothing else, serving nothing at all.
    With ``plain_tol``, the forward also runs once on the plain path, and
    the two losses must agree within it.  Returns the forward's launches
    of ``kernel``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_lm_batch, synthetic_tokens
    from repro_torch.launch.serve import Request, serve_batch
    from repro_torch.models.transformer import lm_init, lm_loss
    from repro_torch.runtime.serve import _dtype
    from repro_torch.tree import leaves

    cfg = get_config(arch).override({"parallel.use_flash_kernel": True})
    m = cfg.model
    check({k: getattr(m, k) for k in full_width} == full_width,
          f"{arch} is not at full width: {m}")
    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm_init(0, m, _dtype(cfg.parallel.param_dtype), dev)
    torch.cuda.synchronize()
    pbytes = sum(l.numel() * l.element_size() for l in leaves(params))
    print(f"{arch}: {m.num_layers} layers, d_model {m.d_model}, "
          f"{len(leaves(params))} leaves, {pbytes / 1e9:.3f} GB of "
          f"{cfg.parallel.param_dtype} parameters, init "
          f"{time.perf_counter() - t0:.2f} s")
    b, s = fwd_shape
    batch = {k: torch.as_tensor(a, device=dev) for k, a in
             synthetic_lm_batch(b, s, m.vocab_size, seed=0).items()}
    cd = _dtype(cfg.parallel.compute_dtype)

    def forward(use_kernel=cfg.parallel.use_flash_kernel):
        with torch.no_grad():
            return lm_loss(params, batch, m, cd, cfg.parallel.remat,
                           use_kernel=use_kernel)

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    loss, met = forward()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    want = {k: (m.num_layers if k == kernel else 0) for k in counts}
    check(counts == want, f"{arch} forward: launches {counts}, expected "
          f"{want}")
    fwd_launches = counts[kernel]
    check(math.isfinite(float(loss)) and float(met["tokens"]) == b * s,
          f"{arch} forward: loss {float(loss)}, tokens {met['tokens']}")
    t0 = time.perf_counter()
    loss2, _ = forward()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check(torch.equal(loss, loss2), f"{arch}: two forwards differ")
    print(f"{arch} lm_loss forward, B {b} x S {s}, use_flash_kernel: loss "
          f"{float(loss):.6f} (ln vocab {math.log(m.vocab_size):.3f}), wall "
          f"{cold:.3f} s cold, {warm:.3f} s warm, launches {counts} as "
          f"expected, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    if plain_tol is not None:
        t0 = time.perf_counter()
        plain, _ = forward(use_kernel=False)
        torch.cuda.synchronize()
        gap = abs(float(loss) - float(plain))
        check(gap <= plain_tol, f"{arch} forward: loss through the kernel "
              f"{float(loss)}, plain {float(plain)}: {gap} > {plain_tol}")
        print(f"{arch} lm_loss forward on the plain path: loss "
              f"{float(plain):.6f}, wall {time.perf_counter() - t0:.3f} s; "
              f"|kernel - plain| {gap:.3e} (limit {plain_tol})")
        del plain
    del batch, loss, loss2, met

    scfg = get_config(arch, "decode_32k")
    check(scfg.parallel.cache_dtype == "bfloat16", "cache is not bf16")
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(128, 1025, SERVE_REQUESTS)]
    reqs = [Request(i, synthetic_tokens(1, n, m.vocab_size, seed=i)[0])
            for i, n in enumerate(lens)]
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    serve_batch(scfg, reqs, SERVE_TOKENS, device=dev, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    check(not any(counts.values()), f"{arch} serve: launches {counts}")
    for r in reqs:
        check(len(r.generated) == SERVE_TOKENS and all(
            0 <= t < m.vocab_size for t in r.generated),
              f"{arch} serve: request {r.rid} generated {r.generated}")
    print(f"{arch} serve_batch: prompts {lens}, {SERVE_TOKENS} tokens each, "
          f"wall {wall:.3f} s, no kernel launched (prefill and decode take "
          f"the plain attention / scan, as in the reference)")
    del params
    torch.cuda.empty_cache()
    return fwd_launches


def phase_lm_paths(dev):
    launches = {}
    launches["flash_attention"] = drive_lm(
        dev, "qwen3-14b", QWEN_FWD, "flash_attention",
        dict(num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
             head_dim=128, d_ff=17408, vocab_size=151936))
    launches["wkv6"] = drive_lm(
        dev, "rwkv6-1.6b", RWKV_FWD, "wkv6",
        dict(num_layers=24, d_model=2048, num_heads=32, head_dim=64,
             d_ff=7168, vocab_size=65536), plain_tol=RWKV_PLAIN_LOSS_TOL)
    return launches


def phase_lm_small_reference(dev):
    """On the card at smoke width, fp32, TF32 off: ``lm_apply`` through the
    kernels against the plain path (1e-4), and prefill + decode against
    the teacher-forced forward (5e-4, the reference's pin), for both
    architectures and the sliding-window ring."""
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import (lm_apply, lm_decode_step,
                                                lm_init, lm_prefill)

    def setup(arch, seq, over=None):
        cfg = reduce_for_smoke(get_config(arch, "train_4k"), seq_len=seq,
                               batch=2)
        if over:
            cfg = cfg.override(over)
        m = cfg.model
        params = lm_init(0, m, torch.float32, dev)
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, m.vocab_size, (2, seq)), device=dev)
        return m, params, toks

    with torch.no_grad():
        for arch in ("qwen3-14b", "rwkv6-1.6b"):
            m, params, toks = setup(arch, 100)
            a, _ = lm_apply(params, {"tokens": toks}, m, use_kernel=False)
            b, _ = lm_apply(params, {"tokens": toks}, m, use_kernel=True)
            d = float((a - b).abs().max())
            check(d <= 1e-4, f"{arch} small: kernel path vs plain {d}")
            print(f"small input, {arch} lm_apply (2 x 100), kernel path vs "
                  f"plain path: max abs diff {d:.3e} (pin 1e-4)")
        for arch, seq, pre, over in (
                ("qwen3-14b", 12, 8, None), ("rwkv6-1.6b", 12, 8, None),
                ("qwen3-14b", 24, 6, {"model.attention": "sliding",
                                      "model.sliding_window": 5})):
            m, params, toks = setup(arch, seq, over)
            full, _ = lm_apply(params, {"tokens": toks}, m)
            lg, state, idx = lm_prefill(params, {"tokens": toks[:, :pre]}, m,
                                        cache_len=seq,
                                        cache_dtype=torch.float32)
            errs = [float((lg - full[:, pre - 1]).abs().max())]
            for t in range(pre, seq):
                lg, state = lm_decode_step(params, toks[:, t], state, t, m)
                errs.append(float((lg - full[:, t]).abs().max()))
            check(max(errs) < 5e-4, f"{arch} {over}: decode drift {errs}")
            print(f"small input, {arch}{' ring' if over else ''}: prefill "
                  f"{pre} + decode to {seq} vs forward, max abs diff "
                  f"{max(errs):.3e} (pin 5e-4)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(dev)}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({secs})")
    for name in build.SOURCES:
        print(f"nvcc report for {name}:\n{build.build_log(name).strip()}")

    t0 = time.perf_counter()
    rows = [phase_kernel_vs_plain(dev), phase_dp_clip(dev),
            phase_boundary_fuse(dev), *phase_agg_fuse(dev),
            phase_flash_attention(dev), phase_wkv6(dev)]
    print(f"kernel vs plain: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = phase_main_paths(dev)
    print(f"main paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(phase_lm_paths(dev))
    print(f"LM paths: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        row["launches"] = launches[row["name"]]
    t0 = time.perf_counter()
    phase_small_reference(dev)
    phase_lm_small_reference(dev)
    print(f"small references: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
