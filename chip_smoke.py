#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check
them.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases; a failure in any of them ends the script with a traceback and a
non-zero exit, and no result line:

1. the card — CUDA required; nvidia-smi's name and power limit printed;
   TF32 off, since the configuration computes in float32;
2. build — every kernel (fedavg, dp_clip, boundary_fuse, agg_fuse), from
   ``src/repro_torch/csrc``, one ``nvcc`` (sm_90a) per source, all started
   together;
3. kernel vs plain — each kernel on the card at the shapes the main paths
   give it, and at ragged sizes, held against its plain PyTorch version;
   kernel, plain and library-call times from CUDA events, beside the
   card's bound for the same work;
4. the main paths — ``FSLGANTrainer.train_epoch`` on ``dcgan-mnist`` at
   full width (5 clients, batch 256, base_filters 64, latent 100, Adam
   2e-4) with ``fed.kernel_aggregation``, 2 rounds x 2 batches per client,
   seven times: plain; with DP-SGD through the dp_clip kernel
   (``privacy.use_kernel``); with the executed split and the fused
   ``int8+dp`` boundary stage through the boundary_fuse kernel
   (``split.use_kernel``); the int8 uplink with the stream server reduce
   (dequant_acc) and with the batched one (dequant_reduce); the top-k
   uplink with the stream reduce (scatter_acc); the edge hierarchy (2
   cohorts) with int8 and the stream reduce.  Every launch count is set to
   0 just before a path and read just after it, and must be exactly what
   the path runs;
5. the output — finite losses, every parameter on the card, generated
   images in range, epsilon finite and growing, the LAN and edge bytes the
   split and the codec predict, the server's peak of live trees; and on
   small inputs the kernel round against the sequential round with the
   host FedAvg, the DP-SGD engine round against the sequential one, the
   identity-stage split round against the unsplit one, one uplink-DP round
   with the int8 codec, and the stream and batched reduce against the
   decode reduce (flat, hierarchical, fedasync, fedbuff).

Prints ``{"kernels": [...]}`` on a line of its own and, as the last line,
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
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
    the clip), the vectorised N % 4 == 0 path, ragged N, B = 1, an all-zero
    row, rows all under the clip, noise_scale 0 and > 0 with injected
    noise; then times at the main path's shape."""
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
          f"{n_full}), max abs err {max_abs:.3e} (tolerance {KERNEL_TOL}; "
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
    none, fp16 and int8: the main path's (256, 6272) and (256, 4096)
    crossings, ragged N, an all-zero tensor (int8 scale 1.0), noise 0 and
    > 0 with injected noise, and the qdq before the clip bit for bit; then
    times at the main path's shapes."""
    from repro_torch.core.split import (CodecBoundaryStage,
                                        GaussianBoundaryStage)
    from repro_torch.fed.transport import make_codec
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.kernels.boundary_fuse.ref import (codec_qdq,
                                                       fused_boundary_ref)

    gen = torch.Generator(device=dev).manual_seed(3)
    main_shapes = ((BATCH, 6272), (BATCH, 4096))
    max_abs, n_cases = 0.0, 0
    for codec in ("none", "fp16", "int8"):
        for b, n in main_shapes + ((BATCH, 1), (3, 4097), (BATCH, 4097)):
            x = torch.randn((b, n), generator=gen, device=dev) * 0.05
            z = torch.randn((b, n), generator=gen, device=dev)
            for ns in (0.0, 0.5):
                got = boundary_fuse_kernel(x, 1.0, ns, z, codec=codec)
                want = fused_boundary_ref(x, 1.0, ns, z, codec=codec)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **KERNEL_TOL)
                max_abs = max(max_abs, float((got - want).abs().max()))
                n_cases += 1
            q = boundary_fuse_kernel(x, 1e30, 0.0, z, codec=codec)
            check(torch.equal(q, codec_qdq(x, codec)),
                  f"boundary_fuse {codec} qdq differs from the codec's at "
                  f"{(b, n)}")
        zero = torch.zeros(main_shapes[0], device=dev)
        check(torch.equal(boundary_fuse_kernel(zero, 1.0, 0.0, zero,
                                               codec=codec), zero),
              f"boundary_fuse {codec}: an all-zero tensor did not stay 0")
    # a NaN propagates as in the reference: int8 scale 1.0, the NaN's whole
    # row NaN (its norm is NaN), every other element as the plain version
    x = torch.randn(main_shapes[0], generator=gen, device=dev) * 0.05
    z = torch.randn(main_shapes[0], generator=gen, device=dev)
    nan_row = main_shapes[0][0] // 3
    x[nan_row, 1234] = float("nan")
    for clip, ns in ((1e30, 0.0), (1.0, 0.5)):
        got = boundary_fuse_kernel(x, clip, ns, z, codec="int8")
        want = fused_boundary_ref(x, clip, ns, z, codec="int8")
        torch.cuda.synchronize()
        check(torch.equal(torch.isnan(got), torch.isnan(want))
              and bool(torch.isnan(want[nan_row]).all())
              and int(torch.isnan(want).sum()) == want.shape[1],
              f"boundary_fuse int8 with a NaN: NaN at other places than the "
              f"plain version (clip {clip})")
        keep = ~torch.isnan(want)
        if clip == 1e30:
            check(torch.equal(got[keep], want[keep]),
                  "boundary_fuse int8 with a NaN: the qdq differs")
        else:
            torch.testing.assert_close(got[keep], want[keep], **KERNEL_TOL)
    print(f"boundary_fuse vs plain: {n_cases} cases (codecs none/fp16/int8, "
          f"N up to 6272), max abs err {max_abs:.3e} (tolerance "
          f"{KERNEL_TOL}); qdq before the clip equal bit for bit; all-zero "
          f"tensors stay 0; int8 with one NaN in {main_shapes[0]}: NaN in the "
          f"same places (its row), the qdq equal bit for bit elsewhere")

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
            "plain": lambda: fused_boundary_ref(x, 1.0, ns, z, codec=codec),
            "library": unfused})
        nbytes = 4 * 3 * b * n
        bound, by = bound_ms(nbytes, BOUNDARY_OPS[codec] * b * n)
        rows[(b, n)] = (t["device"], bound, by)
        print(f"boundary_fuse int8 ({b}, {n}): bound {bound:.4f} ms ({by}: "
              f"{nbytes} B at 3.35 TB/s)")
        for mode, tm in t.items():
            print(f"  {mode:6s} kernel {tm['kernel']:.4f} ms, plain "
                  f"{tm['plain']:.4f} ms, composed stages "
                  f"{tm['library']:.4f} ms")
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
    from repro_torch.kernels.agg_fuse.kernel import (dequant_acc_kernel,
                                                     dequant_reduce_kernel,
                                                     scatter_acc_kernel)
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
    print(f"agg_fuse vs plain: dequant_reduce {n_cases['dequant_reduce']} "
          f"cases (every D leaf, the whole D, N = 1, 4097, 5000; int8, fp16, "
          f"fp32), max abs err {err['dequant_reduce']:.3e} (tolerance "
          f"{KERNEL_TOL}), two launches equal bit for bit; dequant_acc "
          f"{n_cases['dequant_acc']} folds (largest leaf, a round's 60, "
          f"ragged; int8, fp16, fp32), equal bit for bit, max abs err "
          f"{err['dequant_acc']:.3e}; scatter_acc {n_cases['scatter_acc']} "
          f"folds (K = 1% of each leaf, distinct: equal to index_add bit for "
          f"bit; colliding and out-of-range at tolerance), max abs err "
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
    # row 6: a round's 60 top-k folds, in place
    accs = [torch.zeros((n,), device=dev) for n in sizes]
    folds = [(accs[k], client[k][0][0], client[k][0][1], w_host[ci])
             for ci, client in enumerate(rounds["topk"])
             for k in range(len(sizes))]
    t = time_variants({
        "kernel": lambda: [scatter_acc_kernel(a, v, i, wc)
                           for a, v, i, wc in folds],
        "plain": lambda: [scatter_acc_ref(a, v, i, wc)
                          for a, v, i, wc in folds],
        "library": lambda: [a.index_add_(0, i, v, alpha=wc)
                            for a, v, i, wc in folds]})
    kept = sum(v.numel() for _, v, _, _ in folds)
    nbytes = 16 * kept
    bound, by = bound_ms(nbytes, 2 * kept)
    rows[("scatter_acc", "topk")] = (t["device"], bound, by)
    print(f"scatter_acc, a round's {len(folds)} top-k folds ({kept} kept "
          f"entries): bound {bound:.6f} ms ({by}: {nbytes} B at 3.35 TB/s)")
    for mode, tm in t.items():
        print(f"  {mode:6s} kernel {tm['kernel']:.5f} ms, plain "
              f"{tm['plain']:.5f} ms, index_add_ {tm['library']:.5f} ms")

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
    from repro_torch.kernels.agg_fuse.kernel import (dequant_acc_kernel,
                                                     dequant_reduce_kernel,
                                                     scatter_acc_kernel)
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
    from repro_torch.kernels.fedavg.kernel import fedavg_kernel
    return {"fedavg": fedavg_kernel, "dp_clip": dp_clip_noise_kernel,
            "boundary_fuse": boundary_fuse_kernel,
            "dequant_reduce": dequant_reduce_kernel,
            "dequant_acc": dequant_acc_kernel,
            "scatter_acc": scatter_acc_kernel}


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
             {"scatter_acc": folds})):
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
            phase_boundary_fuse(dev), *phase_agg_fuse(dev)]
    print(f"kernel vs plain: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = phase_main_paths(dev)
    print(f"main paths: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        row["launches"] = launches[row["name"]]
    t0 = time.perf_counter()
    phase_small_reference(dev)
    print(f"small references: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
