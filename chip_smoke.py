#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases; a failure in any of them ends the script with a traceback and a
non-zero exit, and no result line:

1. the card — CUDA required; nvidia-smi's name and power limit printed;
   TF32 off, since the configuration computes in float32;
2. build — every kernel of the path, from ``src/repro_torch/csrc``, one
   ``nvcc`` (sm_90a) per source, all started together;
3. kernel vs plain — each kernel on the card at the shapes the main path
   gives it, and at ragged sizes, held against its plain PyTorch version;
   kernel, plain and library-call times from CUDA events, beside the
   card's bound for the same work;
4. the main path — ``FSLGANTrainer.train_epoch`` on ``dcgan-mnist`` at
   full width (5 clients, batch 256, base_filters 64, latent 100, Adam
   2e-4) with ``fed.kernel_aggregation``: 2 rounds x 2 batches per client,
   kernel launch counts set to 0 just before and read just after;
5. the output — finite losses, every parameter on the card, generated
   images in range, and on a small input the kernel round held against the
   sequential round with the host FedAvg.

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
    return start.elapsed_time(end) / (replays * reps)


def fedavg_bound_ms(shapes):
    """Least time the card could take for weighted reduces of these (C, N)
    stacks: the larger of bytes (stack + weights read once, output written
    once) over HBM bandwidth and 2*C*N fp32 operations over the fp32 peak."""
    nbytes = sum(4 * (c * n + c + n) for c, n in shapes)
    flops = sum(2 * c * n for c, n in shapes)
    t_bytes, t_ops = nbytes / HBM_BPS, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


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
        """ms of the kernel, the plain version and the library call, each
        the median of three turns: "eager" as the main path calls them
        (host dispatch included), "device" from CUDA-graph replay."""
        fns = {"kernel": lambda: [fedavg_kernel(x, w) for x in xs],
               "plain": lambda: [fedavg_ref(x, w) for x in xs],
               "library": lambda: [w @ x for x in xs]}
        out = {}
        for mode, timer in (("eager", time_ms), ("device", graph_ms)):
            runs = {k: [] for k in fns}
            for order in (("plain", "kernel", "library"),
                          ("library", "kernel", "plain"),
                          ("kernel", "plain", "library")):
                for name in order:
                    runs[name].append(timer(fns[name]))
            out[mode] = {k: float(np.median(v)) for k, v in runs.items()}
        return out

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


def phase_main_path(dev):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gan import FSLGANTrainer
    from repro_torch.data import partition_dirichlet, synthetic_mnist
    from repro_torch.kernels.fedavg.kernel import fedavg_kernel
    from repro_torch.tree import leaves

    cfg = get_config("dcgan-mnist").override({"fed.kernel_aggregation": True})
    c = cfg.model.dcgan
    check((cfg.fsl.num_clients, cfg.shape.global_batch, c.base_filters,
           c.latent_dim, cfg.optim.lr) == (CLIENTS, 256, 64, 100, 2e-4),
          "dcgan-mnist is not at full width")
    # the paper's 24 batches x 256 examples per client
    imgs, labels = synthetic_mnist(24 * 256 * CLIENTS, seed=0)
    parts = partition_dirichlet(imgs, labels, CLIENTS, alpha=0.5, seed=0)
    tr = FSLGANTrainer(cfg, parts, seed=0)
    n_leaves = len(leaves(tr.state.d_params[tr.client_ids[0]]))

    fedavg_kernel.launches = 0
    hist = []
    for r in range(ROUNDS):
        t0 = time.perf_counter()
        m = tr.train_epoch(batches_per_client=BATCHES)
        torch.cuda.synchronize()
        hist.append(m)
        print(f"round {r}: wall {time.perf_counter() - t0:.3f} s, d_loss "
              f"{m['d_loss']:.6f}, g_loss {m['g_loss']:.6f}, clients "
              f"{m['num_clients']:.0f}, virtual round {m['round_time_s']:.1f} s, "
              f"up {m['up_mbytes']:.3f} MB")
    launches = fedavg_kernel.launches

    check(launches == n_leaves * ROUNDS,
          f"fedavg kernel launched {launches} times, expected "
          f"{n_leaves} leaves x {ROUNDS} rounds")
    for m in hist:
        check(math.isfinite(m["d_loss"]) and math.isfinite(m["g_loss"]),
              f"non-finite loss {m}")
        check(m["num_clients"] == CLIENTS, f"clients dropped: {m}")
    st = tr.state
    trees = [st.g_params, st.g_opt] + list(st.d_params.values()) \
        + list(st.d_opt.values())
    for t in trees:
        for leaf in leaves(t):
            check(leaf.device.type == "cuda", f"a parameter on {leaf.device}")
            check(bool(torch.isfinite(leaf.float()).all()),
                  "non-finite parameter")
    img = tr.generate(16)
    check(img.shape == (16, 28, 28, 1) and np.isfinite(img).all()
          and np.abs(img).max() <= 1.0, "generated images out of shape/range")
    print(f"main path: {ROUNDS} rounds x {BATCHES} batches x {CLIENTS} "
          f"clients, fedavg launches {launches} ({n_leaves} leaves x "
          f"{ROUNDS} rounds), parameters finite on {dev}")
    return launches


def phase_small_reference(dev):
    """The kernel round against the sequential round with the host FedAvg
    (the port's plain reference path), on the card at a small width."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gan import FSLGANTrainer
    from repro_torch.data import partition_dirichlet, synthetic_mnist
    from repro_torch.tree import leaves

    small = {"shape.global_batch": 8, "fsl.num_clients": 2,
             "model.dcgan.base_filters": 8}
    imgs, labels = synthetic_mnist(120, seed=0)
    parts = partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)
    ta = FSLGANTrainer(get_config("dcgan-mnist").override(
        {**small, "fed.kernel_aggregation": True}), parts, seed=0)
    tb = FSLGANTrainer(get_config("dcgan-mnist").override(small), parts,
                       seed=0)
    start = [t.clone() for t in leaves(ta.state.g_params)
             + leaves(ta.state.d_params["c0"])]
    for _ in range(ROUNDS):
        ma = ta.train_epoch(batches_per_client=BATCHES)
        mb = tb.train_epoch_sequential(batches_per_client=BATCHES)
        for k in ("d_loss", "g_loss"):
            check(abs(ma[k] - mb[k]) <= 1e-4 * abs(mb[k]),
                  f"{k}: kernel round {ma[k]} vs sequential {mb[k]}")
    drift = ta.cfg.optim.lr * ROUNDS * BATCHES
    worst = 0.0
    for tree_a, tree_b in ((ta.state.g_params, tb.state.g_params),
                           (ta.state.d_params["c0"], tb.state.d_params["c0"])):
        for p, a, b in zip(paths(tree_a), leaves(tree_a), leaves(tree_b)):
            s = start.pop(0)
            if p[-2:] in BN_FED_BIASES:
                for side in (a, b):
                    check(float((side - s).abs().max()) <= drift,
                          f"{p} drifted beyond lr x steps")
            else:
                d = float((a - b).abs().max())
                worst = max(worst, d)
                check(d <= 1e-4, f"{p}: kernel round vs sequential {d}")
    print(f"small input: kernel round vs sequential host-FedAvg round, "
          f"losses within 1e-4 rel, params max abs diff {worst:.3e}")


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

    row = phase_kernel_vs_plain(dev)
    row["launches"] = phase_main_path(dev)
    phase_small_reference(dev)

    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
