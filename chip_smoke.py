#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases; a failure in any of them ends the script with a traceback and a
non-zero exit, and no result line:

1. the card — CUDA required; nvidia-smi's name and power limit printed;
   TF32 off, since the configuration computes in float32;
2. build — every kernel (fedavg, dp_clip, boundary_fuse), from
   ``src/repro_torch/csrc``, one ``nvcc`` (sm_90a) per source, all started
   together;
3. kernel vs plain — each kernel on the card at the shapes the main paths
   give it, and at ragged sizes, held against its plain PyTorch version;
   kernel, plain and library-call times from CUDA events, beside the
   card's bound for the same work;
4. the main paths — ``FSLGANTrainer.train_epoch`` on ``dcgan-mnist`` at
   full width (5 clients, batch 256, base_filters 64, latent 100, Adam
   2e-4) with ``fed.kernel_aggregation``, 2 rounds x 2 batches per client,
   three times: plain; with DP-SGD through the dp_clip kernel
   (``privacy.use_kernel``); with the executed split and the fused
   ``int8+dp`` boundary stage through the boundary_fuse kernel
   (``split.use_kernel``).  Every launch count is set to 0 just before a
   path and read just after it;
5. the output — finite losses, every parameter on the card, generated
   images in range, epsilon finite and growing, the LAN bytes the split
   predicts; and on small inputs the kernel round against the sequential
   round with the host FedAvg, the DP-SGD engine round against the
   sequential one, the identity-stage split round against the unsplit one,
   and one uplink-DP round with the int8 codec.

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
    print(f"boundary_fuse vs plain: {n_cases} cases (codecs none/fp16/int8, "
          f"N up to 6272), max abs err {max_abs:.3e} (tolerance "
          f"{KERNEL_TOL}); qdq before the clip equal bit for bit; all-zero "
          f"tensors stay 0")

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


def kernel_wrappers():
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
    from repro_torch.kernels.fedavg.kernel import fedavg_kernel
    return {"fedavg": fedavg_kernel, "dp_clip": dp_clip_noise_kernel,
            "boundary_fuse": boundary_fuse_kernel}


def drive_path(dev, label, over, parts):
    """One main path: ``train_epoch`` at full width, ROUNDS x BATCHES, with
    every kernel's launch count set to 0 just before and read just after.
    Checks finite losses and every parameter finite on the card."""
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
            "dp_epsilon", "lan_mbytes") if k in m)
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
    n_leaves = len(leaves(st.d_params[tr.client_ids[0]]))
    check(counts["fedavg"] == n_leaves * ROUNDS,
          f"{label}: fedavg kernel launched {counts['fedavg']} times, "
          f"expected {n_leaves} leaves x {ROUNDS} rounds")
    print(f"{label}: {ROUNDS} rounds x {BATCHES} batches x {CLIENTS} "
          f"clients, launches {counts}, parameters finite on {dev}")
    return tr, hist, counts


def phase_main_paths(dev):
    from repro_torch.data import partition_dirichlet, synthetic_mnist

    # the paper's 24 batches x 256 examples per client
    imgs, labels = synthetic_mnist(24 * BATCH * CLIENTS, seed=0)
    parts = partition_dirichlet(imgs, labels, CLIENTS, alpha=0.5, seed=0)
    launches = {}

    tr, _, counts = drive_path(dev, "main path", {}, parts)
    check(counts["dp_clip"] == counts["boundary_fuse"] == 0,
          f"main path: a DP or split kernel ran: {counts}")
    launches["fedavg"] = counts["fedavg"]
    img = tr.generate(16)
    check(img.shape == (16, 28, 28, 1) and np.isfinite(img).all()
          and np.abs(img).max() <= 1.0, "generated images out of shape/range")

    tr, hist, counts = drive_path(dev, "dp-sgd path", DP_SGD, parts)
    want = CLIENTS * BATCHES * ROUNDS
    check(counts["dp_clip"] == want,
          f"dp_clip launched {counts['dp_clip']} times, expected {CLIENTS} "
          f"clients x {BATCHES} batches x {ROUNDS} rounds = {want}")
    eps = [m["dp_epsilon"] for m in hist]
    check(all(math.isfinite(e) for e in eps) and eps[1] > eps[0] > 0,
          f"dp_epsilon not finite and growing: {eps}")
    launches["dp_clip"] = counts["dp_clip"]

    tr, hist, counts = drive_path(dev, "split path", SPLIT, parts)
    bounds = sum(ex.num_boundaries for ex in tr.split_execs.values())
    want = sum(4 * ex.num_boundaries * BATCHES * ROUNDS
               for ex in tr.split_execs.values())
    check(counts["boundary_fuse"] == want,
          f"boundary_fuse launched {counts['boundary_fuse']} times, expected"
          f" 4 x {bounds} boundaries x {BATCHES} batches x {ROUNDS} rounds "
          f"= {want}")
    x_shape = (BATCH, 28, 28, 1)
    lan = sum(BATCHES * ex.step_wire_bytes(tr.state.d_params[cid],
                                           x_shape)[0]
              for cid, ex in tr.split_execs.items())
    for m in hist:
        check(m["lan_mbytes"] == lan / 1e6,
              f"lan_mbytes {m['lan_mbytes']} != step_wire_bytes {lan / 1e6}")
    print(f"split path: {bounds} boundaries over {CLIENTS} clients, "
          f"lan_mbytes {lan / 1e6} as step_wire_bytes predicts")
    launches["boundary_fuse"] = counts["boundary_fuse"]
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
    round with the int8 codec."""
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
            phase_boundary_fuse(dev)]
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
