#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check
them.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases; a failure in any of them ends the script with a traceback and a
non-zero exit, and no result line:

1. the card — CUDA required; nvidia-smi's name and power limit printed;
   cuDNN's TF32 flag left at PyTorch's default (on): the trainer's entry
   points compute their convolutions in float32 themselves, and the
   direct module calls that compare convolutions take the same guard;
2. build — every kernel (fedavg, dp_clip, boundary_fuse, agg_fuse,
   flash_attention, wkv6), from ``src/repro_torch/csrc``, one ``nvcc``
   (sm_90a) per source, all started together;
3. kernel vs plain — each kernel on the card at the shapes the main paths
   give it, and at ragged sizes and edge cases, held against its plain
   PyTorch version (boundary_fuse also as the per-example int8+dp stage at
   the DP-SGD split path's crossings, one ``amax="row"`` launch each, and
   at the vectorized DP-SGD split's crossings: each signature group's
   C x B rows, its clients' noise draws concatenated);
   kernel, plain and library-call times from CUDA events,
   beside the card's bound for the same work (fedavg's also with the L2
   flushed before every call);
4. the main paths — ``FSLGANTrainer.train_epoch`` on ``dcgan-mnist`` at
   full width (5 clients, batch 256, base_filters 64, latent 100, Adam
   2e-4) with ``fed.kernel_aggregation``, 2 rounds x 2 batches per client,
   ten times: plain; with DP-SGD through the dp_clip kernel
   (``privacy.use_kernel``); with the executed split and the fused
   ``int8+dp`` boundary stage through the boundary_fuse kernel
   (``split.use_kernel``; one launch a crossing: 4 x boundaries x 2 x 2);
   the same split pipelined over 4 micro-batches of 64 (4 x 4 x
   boundaries x 2 x 2); DP-SGD through the split (the per-example staged
   step: one ``amax="row"`` launch a crossing for the whole batch, 4 x
   boundaries x 2 x 2, and dp_clip 20) — each of these five with the
   fedavg kernel, one launch a round: 2; each split path with one more
   round under ``torch.profiler`` for boundary_fuse's device time, and
   the per-example staged step timed against the unsplit DP step's
   vmap; the int8 uplink with the stream server reduce
   (dequant_acc, one launch a client's fold: 10) and with the batched one
   (dequant_reduce, one launch a round: 2); the top-k uplink with the
   stream reduce (scatter_acc, one launch a fold: 10); the edge hierarchy
   (2 cohorts) with int8 and the stream reduce (dequant_acc 10, fedavg 2)
   and with the decode reduce (fedavg 6: each cohort's pre-reduce and the
   server's average, one launch each a round); the first five again under
   ``fed.backend="vectorized"`` (the clients of a split signature stacked
   under ``torch.func.vmap``; fedavg 2 each; dp_clip 20, one a client a
   step; boundary_fuse 112 and 448, one a crossing a client; on the
   DP-SGD split 4 x each signature group's boundaries x 2 x 2, one
   ``amax="row"`` launch a crossing a group), each warm round printed
   beside its loop path's; ``fed.backend="auto"`` on the plain, split and
   DP-SGD split paths (fedavg 2; the probe's dispatch runs the step's
   kernels for 4 loop and 4 vectorized rounds more: a warm-up and 3 timed
   runs each), with the probe's
   two times and its pick beside the loop and vectorized warm rounds; and
   ``fed.shard_clients`` on one card (no mesh) against the unsharded
   vectorized round, bit for bit.  Then the LM substrate at
   full width, every arch of ``LM_PATHS``: ``lm_loss`` forward
   (``torch.no_grad``, ``parallel.use_flash_kernel``; B 2 x S 2048,
   rwkv6-1.6b B 4 x T 2048, whisper-base B 2 x S 448 with its frame
   embeddings, chameleon-34b on interleaved image tokens) and
   ``serve_batch`` (4 requests, 16 greedy tokens, bf16 cache) on
   qwen3-14b, rwkv6-1.6b, olmoe-1b-7b, deepseek-v2-lite-16b,
   recurrentgemma-9b, whisper-base, chameleon-34b, granite-20b,
   qwen2-72b (32 of its 80 layers) and llama3-405b (8 of 126): one
   flash_attention launch an ``attn`` / ``moe`` layer and one wkv6
   launch an ``rwkv`` layer a forward, two forwards equal bit for bit;
   serving launches neither, as in the reference.  Then LM training at
   full width (``phase_train_paths``), which launches no hand-written
   kernel (they are forward-only, as in the reference): ``train_loop``
   on rwkv6-1.6b (24 layers, fp32 parameters and AdamW state, bf16
   compute, B 4 x T 1024, 2 steps), ``make_train_step`` on qwen3-14b (4
   of 40 layers, bf16, 8 micro-batches of 1 x 2048, 2 steps) and
   ``make_fsl_train_step`` on whisper-base (3 clients x B 8 x 448,
   FedAvg every 2 steps, 4 steps), each with its warm step's wall, tokens
   a second and peak memory; a train step built with
   ``use_flash_kernel`` is refused.  And the adaptive path at full width
   (``phase_adaptive_path``, 3 rounds x 2 batches): ``control.mode=
   "adaptive"`` with the codec, sigma, split and deadline controllers,
   DP-SGD through the split with the dp_clip and boundary_fuse kernels
   (fused fp16+dp at every boundary, int8+dp where the split controller
   finds a leak), the stream reduce through agg_fuse (scatter_acc on the
   round the codec controller probes top-k, dequant_acc on int8), the
   flight recorder with the kernel profile (fedavg, dp_clip,
   boundary_fuse and dequant_reduce, each its first call and 3 timed
   ones) and the health monitors under ``policy="record"``: each round's
   knobs and the controllers that moved them printed, each round's
   launches equal to what the knobs in force and the clients that ran and
   landed give, the recording replayed to the same knobs bit for bit,
   the trace checked as Chrome-trace JSON, profile.json printed beside the
   H100 roofline terms.  And the attack path at full width
   (``phase_attack_path``): gradient inversion of the plain path's
   trained D (200 steps on a (1, 28, 28, 1) victim), the defended
   re-attack through the dp_clip kernel (1 launch, held against the plain
   version), activation inversion of the tensors an int8+dp split ships
   through the boundary_fuse kernel at each boundary of the client with
   the most (4 x (b + 1) launches at boundary b) beside the clean depth
   sweep, membership inference, the trainer's state through a checkpoint
   onto the card bit for bit, and a roster round's two-tier reduce
   through the fedavg kernel (5 launches) against the flat FedAvg.  And
   the dry run (``phase_dryrun``, after the train paths; fake tensors on
   the CPU, no kernel): ``launch.dryrun.run_pair`` on qwen3-14b
   ``train_4k`` over the (16, 16) mesh and llama3-405b ``decode_32k``
   over (2, 16, 16) with probes (each record's per-chip flops, parameter,
   optimizer and activation bytes, collective bytes and dominant term;
   the probes' prediction at the traced depth against its direct count),
   ``lower_one`` of qwen3-14b at 4 of 40 layers on the one-card host mesh
   against the same step on the card (flops under ``FlopCounterMode``,
   the parameter and optimizer bytes the allocator took, the activation
   estimate beside the warm step's peak), and ``fedavg_collective`` over
   a one-rank NCCL group bit for bit against ``fedavg``.  Every launch
   count is set to 0 just before a path and read just after it, and must
   be exactly what the path runs;
5. the output — finite losses, every parameter on the card, generated
   images in range, epsilon finite and growing (DP-SGD, with and without
   the split), the LAN and edge bytes the split and the codec predict (the
   same on the three split paths), the server's peak of live trees,
   generated tokens in the vocabulary, the rwkv6-1.6b, recurrentgemma-9b
   and granite-20b losses through the kernels against the plain path's
   at full depth; and on small inputs the kernel
   round against the sequential round with the host FedAvg, the DP-SGD
   engine round against the sequential one, the identity-stage split round
   against the unsplit one (and, under deterministic cuDNN, bit for bit in
   every leaf), one uplink-DP round with the int8 codec, the stream and
   batched reduce against the decode reduce (flat, hierarchical, fedasync,
   fedbuff), the pipelined step at K = 1 against the unpipelined one
   (bit for bit), K = 2 against the mean of the chunks' monolithic
   gradients, the batched per-example
   staged step against its loop oracle, DP-SGD through the identity split
   against DP-SGD unsplit, and through the int8+dp split at K = 4 against
   K = 1 (bit for bit), each LM's forward through the kernels against the
   plain path, prefill + decode against the teacher-forced forward
   (full and sliding-window caches), a whisper decode past its cache
   against the CPU; over 3 clients the vectorized round
   against the loop round (plain, DP-SGD, split) at the reference's
   tolerances, ``fed.shard_clients`` on one card against the unsharded
   vectorized round, and rounds with cuDNN's TF32 flag on globally
   against the same rounds with it off, both bit for bit; on the adaptive
   path's configuration, ``control.mode="frozen"`` against no control,
   obs on against obs off and the monitors under ``policy="record"``
   against none, each bit for bit under deterministic cuDNN; the shipped
   prefix through the kernel against the plain stage within one int8
   quantum, 5 gradient-inversion steps on the card against the CPU, and
   ``split_forward`` against the unsplit forward bit for bit; every
   train path's losses and parameters finite, the warm step moving them,
   the FSL replicas equal bit for bit after each FedAvg step and only
   then, and a train step at smoke width on the card against the CPU
   (SGD; gradients and parameters within 1e-5 of a leaf's largest,
   rwkv6-1.6b 1e-4).

Prints ``{"kernels": [...]}`` on a line of its own and, as the last line,
``{"ok": true, "device": {...}}``.
"""
import functools
import json
import math
import os
import re
import shutil
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
PIPELINE_K = 4                  # the pipelined split path's micro-batches
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor) FLOP/s
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12
# kernel vs plain: both sum C fp32 products (5 on the main paths, up to 37
# in the client-chunk cases), in another order (fmaf in client order vs
# PyTorch's reduction), so they differ by a few ulp
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
# Biases that feed straight into a batch norm have a zero analytic
# gradient; Adam turns their rounding-noise gradient into steps of about
# +-lr whose sign the noise picks, so they are held to the most Adam can
# move them from the start (``adam_reach``) instead of to the reference.
BN_FED_BIASES = {("conv1", "b"), ("conv2", "b"), ("deconv0", "b"),
                 ("deconv1", "b")}
# the D biases the reference's backend comparisons skip (their gradient is
# rounding noise that Adam turns into steps of about lr), and its
# tolerances there (tests/test_fed_runtime.py)
DEAD_BIASES = {("conv1", "b"), ("conv2", "b")}
VEC_LOSS_TOL, VEC_PARAM_TOL = 1e-5, 5e-5
# each main path's round wall times, seconds (drive_path)
WALLS = {}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def fp32_convs(fn):
    """``fn`` under the port's fp32-convolution guard: a direct module call
    that compares or times convolutions computes them as the trainer's
    entry points do, whatever the global cuDNN TF32 flag says."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        from repro_torch.device import fp32_convolutions
        with fp32_convolutions():
            return fn(*args, **kwargs)
    return wrapped


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


def time_variants(fns, iters=200, reps=20, modes=("eager", "device")):
    """ms of each variant in ``fns`` (kernel, plain, library), each the
    median of three turns in rotating order: "eager" as the main path
    calls them (host dispatch included), "device" from CUDA-graph replay
    (``modes`` picks which)."""
    names = list(fns)
    out = {}
    timers = {"eager": lambda f: time_ms(f, iters),
              "device": lambda f: graph_ms(f, reps)}
    for mode in modes:
        timer = timers[mode]
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


L2_BYTES = 50 * 2 ** 20         # the H100's L2


def cold_variants(fns, dev, iters=50, modes=("eager", "device")):
    """ms of each variant in ``fns`` when its call finds the L2 cold: before
    every call a buffer of 4x the L2 is written (evicting what the last
    call left) and another of 4x the L2 read (so the lines left are clean
    and the call pays no write-back of the flush), then the call alone is
    timed with CUDA events: "device" one call captured in a CUDA graph and
    replayed while the card is still busy with the flush, "eager" the
    Python call after a synchronise (host dispatch included).  Each the
    median of three turns in rotating order, a turn the mean of ``iters``
    calls."""
    dirty = torch.empty((L2_BYTES,), dtype=torch.float32, device=dev)
    clean = torch.ones((L2_BYTES,), dtype=torch.float32, device=dev)

    def flush():
        dirty.fill_(1.0)
        clean.max()

    def graphed(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return graph

    def timed(call, sync):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            flush()
            if sync:
                torch.cuda.synchronize()
            start.record()
            call()
            end.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in ev) / iters

    names = list(fns)
    out = {}
    for mode in modes:
        if mode == "device":
            graphs = {k: graphed(f) for k, f in fns.items()}
            calls = {k: g.replay for k, g in graphs.items()}
        else:
            calls = fns
        runs = {k: [] for k in names}
        for turn in range(3):
            for name in names[turn:] + names[:turn]:
                runs[name].append(timed(calls[name], mode == "eager"))
        out[mode] = {k: float(np.median(v)) for k, v in runs.items()}
    return out


def fmaf_chain(coefs, rows):
    """One fmaf chain a column over ``rows`` (C, N) in row order from 0,
    in fp32: each product and sum in long double (exact for an fp32
    product), rounded once to fp32 — the CUDA kernels' order of sums,
    emulated on the host."""
    acc = np.zeros(rows.shape[1], np.float32)
    for k, x in zip(coefs, rows):
        acc = (np.longdouble(k) * x.astype(np.longdouble)
               + acc.astype(np.longdouble)).astype(np.float32)
    return acc


def off_by_one(t):
    """A copy of ``t`` that starts one element into its buffer."""
    buf = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:]


def paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]


def phase_fedavg(dev):
    """The fedavg kernel against its plain version: a round's table (the
    12 D leaves of 5 clients read where they lie, one launch) equal to the
    one-leaf tables over each leaf's stack and to the host emulation of
    the fmaf chain bit for bit; aligned and one element off, with empty and
    one-element leaves; 21 and 37 clients (chunks of 16 that continue the
    chain); the one-leaf form over stacks, the whole D and ragged sizes.
    Then a round's times, L2-warm and L2-flushed, against the bound, one
    launch a leaf over stacks, the plain version and ``w @ x``; and the
    whole ``fedavg_trees`` call beside the parent's form of it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.fedavg.kernel import (MAX_CLIENTS,
                                                   fedavg_kernel,
                                                   fedavg_leaves_kernel)
    from repro_torch.kernels.fedavg.ops import fedavg_flat, fedavg_trees
    from repro_torch.kernels.fedavg.ref import fedavg_leaves_ref, fedavg_ref
    from repro_torch.models.dcgan import disc_init
    from repro_torch.tree import leaves, unflatten_like

    c = get_config("dcgan-mnist").model.dcgan
    gen = torch.Generator().manual_seed(1)
    trees = [disc_init(gen, c, dev) for _ in range(CLIENTS)]
    params = [leaves(t) for t in trees]         # client c's leaf l
    sizes = [p.numel() for p in params[0]]
    # the stacks the parent's server reduce built: one (C, N) per D leaf
    stacks = [torch.stack([l.reshape(-1) for l in ls]) for ls in zip(*params)]
    w = torch.rand(CLIENTS, generator=gen).to(dev) + 0.5
    w = w / w.sum()
    w_host = [float(x) for x in w.cpu()]
    err = {"abs": 0.0, "rel": 0.0}
    n_cases = {"one-leaf": 0, "table": 0, "exact": 0}

    def held(got, want, kind):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        e = float((got - want).abs().max()) if got.numel() else 0.0
        err["abs"] = max(err["abs"], e)
        err["rel"] = max(err["rel"], e / max(float(want.abs().max())
                                             if got.numel() else 0.0, 1e-30))
        n_cases[kind] += 1

    def exact(what, got, rows, wc):
        """``got`` is the one-leaf table over ``rows`` and one fmaf chain in
        client order, bit for bit."""
        torch.cuda.synchronize()
        check(torch.equal(got, fedavg_kernel(rows, wc)),
              f"fedavg {what}: not the one-leaf table over the stack")
        check(np.array_equal(got.cpu().numpy(), fmaf_chain(
            wc.cpu().numpy(), rows.cpu().numpy())),
            f"fedavg {what}: not one fmaf chain in client order")
        n_cases["exact"] += 1

    def table(outs, ps, wc, launches, what):
        before = fedavg_leaves_kernel.launches
        got = fedavg_leaves_kernel(outs, ps, wc)
        check(fedavg_leaves_kernel.launches - before == launches,
              f"fedavg {what}: {fedavg_leaves_kernel.launches - before} "
              f"launches, expected {launches}")
        check(all(g is o for g, o in zip(got, outs)),
              f"fedavg {what}: outputs not written in place")
        for g, want in zip(got, fedavg_leaves_ref(ps, wc)):
            held(g, want, "table")
        return got

    # the one-leaf form: every D leaf's stack, the whole D, ragged sizes,
    # one client
    whole = torch.cat(stacks, dim=1).contiguous()
    ragged = [torch.randn((CLIENTS, n), generator=gen).to(dev)
              for n in (1, 4097, 999_999)]
    cases = [(s, w) for s in stacks + [whole] + ragged]
    cases += [(s[:1].contiguous(), torch.ones(1, device=dev))
              for s in (stacks[0], ragged[1])]
    for x, wx in cases:
        held(fedavg_kernel(x, wx), fedavg_ref(x, wx), "one-leaf")
    # the round's table, as fedavg_trees launches it: one launch, twice
    outs = [torch.empty_like(p) for p in params[0]]
    got = table(outs, params, w, 1, "round")
    again = fedavg_leaves_kernel([torch.empty_like(o) for o in outs],
                                 params, w)
    for k, (g, a) in enumerate(zip(got, again)):
        torch.cuda.synchronize()
        check(torch.equal(g, a), f"fedavg round, leaf {k}: not deterministic")
        exact(f"round, leaf {k}", g.reshape(-1), stacks[k], w)
    # one element off 16-byte alignment, with an empty and a one-element
    # leaf among them
    ps = [[off_by_one(p) for p in cl] + [torch.empty((0,), device=dev),
                                         off_by_one(cl[0][:1])]
          for cl in params]
    outs = [off_by_one(torch.empty_like(p)) for p in ps[0]]
    table(outs, ps, w, 1, "one element off")
    # more clients than a launch takes: the ragged leaves, two small D
    # leaves and the largest
    for n_clients in (MAX_CLIENTS + 5, 2 * MAX_CLIENTS + 5):
        shapes = [1, 4097, 5000, 1600, 64, max(sizes)]
        ps = [[torch.randn((n,), generator=gen).to(dev) for n in shapes]
              for _ in range(n_clients)]
        wc = torch.rand((n_clients,), generator=gen).to(dev) + 0.5
        wc = wc / wc.sum()
        got = table([torch.empty((n,), device=dev) for n in shapes], ps, wc,
                    -(-n_clients // MAX_CLIENTS), f"{n_clients} clients")
        for k, g in enumerate(got):
            exact(f"{n_clients} clients, leaf {k}", g,
                  torch.stack([p[k] for p in ps]), wc)
    print(f"fedavg vs plain: {n_cases['one-leaf']} one-leaf cases and "
          f"{n_cases['table']} table leaves (a round's 12 D leaves x "
          f"{CLIENTS} clients in one launch, aligned and one element off "
          f"with empty and one-element leaves; {MAX_CLIENTS + 5} and "
          f"{2 * MAX_CLIENTS + 5} clients in chunks of {MAX_CLIENTS}), max "
          f"abs err {err['abs']:.3e}, max abs err / max |plain| "
          f"{err['rel']:.3e} (tolerance {KERNEL_TOL}); {n_cases['exact']} "
          f"leaves equal to the one-leaf table and to the host fmaf chain "
          f"bit for bit; two launches equal")
    print(f"fedavg: one round reduces {len(stacks)} leaves, N = {sizes}, "
          f"whole D N = {whole.shape[1]}")

    # a round's reduce: one launch over the clients' leaves in place (the
    # main path), one launch a leaf over stacks made beforehand, the plain
    # version and w @ x over the same stacks; L2-warm and L2-flushed
    outs = [torch.empty_like(p) for p in params[0]]
    fns = {"kernel": lambda: fedavg_leaves_kernel(outs, params, w),
           "per_leaf": lambda: [fedavg_kernel(x, w) for x in stacks],
           "plain": lambda: fedavg_leaves_ref(params, w),
           "library": lambda: [w @ x for x in stacks]}
    warm = time_variants(fns)
    cold = cold_variants(fns, dev)
    # what this timing reads for a one-element fill: its floor
    one = torch.empty((1,), device=dev)
    floor = cold_variants({"fill": lambda: one.fill_(1.0)}, dev,
                          modes=("device",))["device"]["fill"]

    # the whole call, eager (the weights go to the card from the host,
    # which a CUDA graph cannot capture): fedavg_trees beside the parent's
    # form of it, a stack a leaf, the weights normalised a leaf and one
    # launch a leaf
    def parent_form():
        wt = torch.tensor(w_host, dtype=torch.float32, device=dev)
        out = []
        for ls in zip(*params):
            stacked = torch.stack([l.reshape(-1).to(torch.float32)
                                   for l in ls])
            out.append(fedavg_flat(stacked, wt).reshape(ls[0].shape)
                       .to(ls[0].dtype))
        return unflatten_like(trees[0], out)

    calls = {"trees": lambda: fedavg_trees(trees, w_host),
             "parent": parent_form}
    warm_call = time_variants(calls, modes=("eager",))["eager"]
    cold_call = cold_variants(calls, dev, modes=("eager",))["eager"]
    bound, by, nbytes = fedavg_bound_ms([tuple(x.shape) for x in stacks])
    print(f"fedavg, a round ({len(stacks)} leaves, C = {CLIENTS}): bound "
          f"{bound:.5f} ms ({by}: {nbytes} B at 3.35 TB/s)")
    for label, t in (("L2-warm", warm), ("L2-flushed", cold)):
        for mode, tm in t.items():
            print(f"  {label:10s} {mode:6s} kernel {tm['kernel']:.5f} ms (1 "
                  f"launch; one a leaf over stacks: {tm['per_leaf']:.5f} ms, "
                  f"{len(stacks)} launches), plain {tm['plain']:.5f} ms, "
                  f"w @ x {tm['library']:.5f} ms")
    print(f"  L2-flushed device timing of a one-element fill (the floor of "
          f"that timing: event, graph launch and an empty kernel): "
          f"{floor:.5f} ms")
    for label, t in (("L2-warm", warm_call), ("L2-flushed", cold_call)):
        print(f"  {label:10s} eager  fedavg_trees of the round "
              f"{t['trees']:.5f} ms; the parent's form (a stack, the weights "
              f"normalised and a launch a leaf) {t['parent']:.5f} ms")
    t = warm["device"]
    return {"name": "fedavg", "route": "cuda",
            "source": "src/repro_torch/csrc/fedavg.cu",
            "replaces": "src/repro/kernels/fedavg/kernel.py:24",
            "launches": None, "max_abs_err": err["abs"],
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
    modes; the per-example stage at the DP-SGD split's crossings, and at
    the vectorized DP-SGD split's group crossings
    (``vectorized_group_crossings``); then times at the main path's
    shapes."""
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
    # the dp-sgd split path's crossings: the fused int8+dp stage's
    # per-example form, one amax="row" launch for the whole batch, against
    # the same stage on the plain version with the same key (same noise)
    from repro_torch import keys
    from repro_torch.core.split import FusedBoundaryStage
    kernel_stage = FusedBoundaryStage("int8", 1.0, 0.5, use_kernel=True)
    plain_stage = FusedBoundaryStage("int8", 1.0, 0.5)
    dp_shapes = ((BATCH, 14, 14, 64), (BATCH, 7, 7, 128), (BATCH, 4, 4, 256))
    for i, shape in enumerate(dp_shapes):
        x = torch.randn(shape, generator=gen, device=dev) \
            * torch.logspace(-3, 0, BATCH, device=dev)[:, None, None, None]
        key = keys.root(keys.DP_SGD, i)
        before = boundary_fuse_kernel.launches
        got = kernel_stage.apply_per_example(x, key)
        check(boundary_fuse_kernel.launches == before + 1,
              "the per-example stage did not launch boundary_fuse once")
        want = plain_stage.apply_per_example(x, key)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        max_abs = max(max_abs, float((got - want).abs().max()))
        n_cases += 1
        calls += 1
    print(f"boundary_fuse per-example int8+dp stage (the dp-sgd split "
          f"path's crossings {[s_[1:] for s_ in dp_shapes]} x {BATCH} "
          f"examples, rows over 3 decades, noise 0.5): 1 amax=row launch "
          f"each, equal to the plain stage within {KERNEL_TOL}")
    group_err, group_cases = vectorized_group_crossings(dev, gen)
    max_abs = max(max_abs, group_err)
    n_cases += len(group_cases)
    calls += len(group_cases)
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


def vectorized_group_crossings(dev, gen):
    """The vectorized dp-sgd split path's crossings, kernel against plain:
    for each signature group of the full-width plans, one amax="row"
    launch a crossing over the group's C x B rows, its noise each client's
    (B, N) draw from its crossing key, concatenated
    (``SplitExecution.group_noise``, as ``clients_per_example_value_and_
    grad`` builds it); forward crossings carry activations, backward ones
    gradients (scaled 1e-4).  Returns the largest error and the (rows, N)
    of each case."""
    from repro_torch import keys
    from repro_torch.core.split import FusedBoundaryStage
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel

    tr = full_width_trainer({**DP_SGD, **SPLIT,
                             "fed.backend": "vectorized"})
    groups = {}
    for cid, ex in tr.split_execs.items():
        groups.setdefault(ex.signature, (ex, []))[1].append(cid)
    max_abs, group_cases = 0.0, []
    for gi, (ex, cids) in enumerate(groups.values()):
        c = len(cids)
        ks = [keys.fold_in(keys.root(keys.DP_SGD, 100 + gi), i)
              for i in range(c)]
        for si, shape in enumerate(ex.boundary_shapes(
                tr.state.d_params[cids[0]], (BATCH, 28, 28, 1))):
            stage = ex.stages[si]
            check(isinstance(stage, FusedBoundaryStage) and stage.use_kernel,
                  f"the trainer's stage {stage.signature} is not the fused "
                  f"kernel stage")
            plain = FusedBoundaryStage(stage.codec_name, stage.clip,
                                       stage.sigma)
            n = math.prod(shape[1:])
            for direction, scale in ((0, 1.0), (1, 1e-4)):
                x = torch.randn((c * BATCH,) + tuple(shape[1:]),
                                generator=gen, device=dev) * scale \
                    * torch.logspace(-3, 0, c * BATCH, device=dev).view(
                        (-1,) + (1,) * (len(shape) - 1))
                noise = ex.group_noise(ks, si, 0, direction, BATCH, n, dev)
                before = boundary_fuse_kernel.launches
                got = stage.apply_per_example(x, noise=noise)
                check(boundary_fuse_kernel.launches == before + 1,
                      f"a group crossing over {c} x {BATCH} rows did not "
                      f"launch boundary_fuse once")
                want = plain.apply_per_example(x, noise=noise)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **KERNEL_TOL)
                max_abs = max(max_abs, float((got - want).abs().max()))
                group_cases.append((c * BATCH, n))
    del tr
    print(f"boundary_fuse per-example int8+dp stage at the vectorized "
          f"dp-sgd split path's group crossings ({len(groups)} signature "
          f"groups of {sorted(len(g[1]) for g in groups.values())} "
          f"clients; (rows, N) {sorted(set(group_cases))}, forward and "
          f"backward, each client's noise draw concatenated): 1 amax=row "
          f"launch each, equal to the plain stage within {KERNEL_TOL}")
    return max_abs, group_cases


def encode_round(dev, codec_name, sizes, seed, clients=CLIENTS):
    """The wires a round's uplinks give the server reduce: each client's
    per-leaf delta (about the size of two Adam steps) through the codec,
    as ``Codec.encode`` makes them on the main path."""
    from repro_torch.fed.transport import make_codec
    gen = torch.Generator(device=dev).manual_seed(seed)
    codec = make_codec("none" if codec_name == "fp32" else codec_name)
    return [[codec.encode(torch.randn((n,), generator=gen, device=dev)
                          * 4e-4) for n in sizes] for _ in range(clients)]


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
    scatter with colliding and out-of-range indices; as one-leaf tables
    and as the tables the main paths launch (a fold's leaves, a round's
    unstacked client wires), also longer than one launch takes and off
    4-element alignment; then times of a round's work against the bound,
    one launch a leaf, the plain version and one library call."""
    from repro_torch.configs.registry import get_config
    from repro_torch.fed.transport import make_codec
    from repro_torch.fed.aggregate import batched_reduce
    from repro_torch.kernels.agg_fuse.kernel import (
        MAX_LEAVES, REDUCE_CLIENTS, dequant_acc_kernel,
        dequant_acc_leaves_kernel, dequant_reduce_kernel,
        dequant_reduce_leaves_kernel, scatter_acc_kernel,
        scatter_acc_leaves_kernel)
    from repro_torch.kernels.agg_fuse.ops import (dequant_acc_leaves,
                                                  dequant_reduce_flat,
                                                  dequant_reduce_leaves,
                                                  scatter_acc_leaves)
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

    # the tables the main paths launch: a round's 5 folds, each over its
    # 15 leaves in one launch (equal bit for bit); a round's reduce over
    # the unstacked client wires in one launch (at tolerance, the same bits
    # twice and as the one-leaf table over each leaf's stack); a fold of
    # 72 leaves (two launches); 21 and 37 clients (two and three launches
    # of 16-client chunks: the same bits as one fmaf chain in client
    # order, emulated on the host); wires, accumulators and outputs one
    # element off 4-element alignment; an all-zero int8 leaf
    n_table = {"dequant_acc": 0, "dequant_reduce": 0}

    def launched(name, wrapper, before, want, what):
        got = wrapper.launches - before
        check(got == want, f"{name} {what}: {got} launches, expected {want}")
        n_table[name] += 1

    for d in ("int8", "fp16", "fp32"):
        rnd = rounds[d]
        n_l = len(rnd[0])
        scales_by_leaf = ([[client[k][1] for client in rnd]
                           for k in range(n_l)] if d == "int8" else None)
        wires_by_leaf = [[client[k][0] for client in rnd]
                         for k in range(n_l)]
        for view in (False, True):
            accs = [torch.randn((ws[0].numel(),), generator=gen, device=dev)
                    for ws in wires_by_leaf]
            if view:
                accs = [off_by_one(a) for a in accs]
            for ci, client in enumerate(rnd):
                wires = [off_by_one(x) if view else x for x, _ in client]
                scales = None if d != "int8" else [sc for _, sc in client]
                want = dequant_acc_leaves(accs, wires, scales, w_host[ci])
                before = dequant_acc_leaves_kernel.launches
                got = dequant_acc_leaves_kernel(accs, wires, w_host[ci],
                                                scales)
                launched("dequant_acc", dequant_acc_leaves_kernel, before,
                         1, f"{d} fold")
                for g, a, wl in zip(got, accs, want):
                    check(g is a, "dequant_acc table did not update in place")
                    held("dequant_acc", g, wl, True)
            wbl = ([[off_by_one(x) for x in ws] for ws in wires_by_leaf]
                   if view else wires_by_leaf)
            outs = [torch.empty((ws[0].numel(),), device=dev) for ws in wbl]
            if view:
                outs = [off_by_one(o) for o in outs]
            before = dequant_reduce_leaves_kernel.launches
            got = dequant_reduce_leaves_kernel(outs, wbl, w, scales_by_leaf)
            again = dequant_reduce_leaves_kernel(
                [torch.empty_like(o) for o in outs], wbl, w, scales_by_leaf)
            launched("dequant_reduce", dequant_reduce_leaves_kernel, before,
                     2, f"{d}, twice")
            for k, (g, a, p) in enumerate(zip(got, again,
                                              dequant_reduce_leaves(
                                                  wbl, scales_by_leaf, w))):
                held("dequant_reduce", g, p, False)
                check(torch.equal(g, a),
                      f"dequant_reduce table {d} is not deterministic")
                sc = (torch.ones_like(w) if scales_by_leaf is None
                      else torch.stack(scales_by_leaf[k]))
                check(torch.equal(g, dequant_reduce_kernel(
                    torch.stack(wbl[k]), torch.stack([w, sc], dim=1))),
                    f"dequant_reduce table {d}, leaf {k}: not the one-leaf "
                    f"table over the stacked rows bit for bit")
        # more clients than a launch takes, on the ragged leaves and two
        # small D leaves
        for n_clients in (REDUCE_CLIENTS + 5, 2 * REDUCE_CLIENTS + 5):
            many = encode_round(dev, d, [1, 4097, 5000, 1600, 64], 50,
                                n_clients)
            wc = torch.rand((n_clients,), generator=gen, device=dev) + 0.5
            wc = wc / wc.sum()
            wbl = [[client[k][0] for client in many] for k in range(5)]
            sbl = ([[client[k][1] for client in many] for k in range(5)]
                   if d == "int8" else None)
            before = dequant_reduce_leaves_kernel.launches
            got = dequant_reduce_leaves_kernel(
                [torch.empty((ws[0].numel(),), device=dev) for ws in wbl],
                wbl, wc, sbl)
            launched("dequant_reduce", dequant_reduce_leaves_kernel, before,
                     -(-n_clients // REDUCE_CLIENTS),
                     f"{d} over {n_clients} clients")
            for k, g in enumerate(got):
                sc = (torch.ones_like(wc) if sbl is None
                      else torch.stack(sbl[k]))
                chain = fmaf_chain((wc * sc).cpu().numpy(),
                                   torch.stack(wbl[k]).float().cpu().numpy())
                torch.cuda.synchronize()
                check(np.array_equal(g.cpu().numpy(), chain),
                      f"dequant_reduce {d} over {n_clients} clients, leaf "
                      f"{k}: not one fmaf chain in client order")
                held("dequant_reduce", g, dequant_reduce_leaves(
                    [wbl[k]], None if sbl is None else [sbl[k]],
                    wc)[0], False)
    rnd = rounds["int8"]
    accs = [torch.randn((x.numel(),), generator=gen, device=dev)
            for x, _ in (rnd[0] * 5)[:72]]
    wires = [x for x, _ in (rnd[1] * 5)[:72]]
    scales = [sc for _, sc in (rnd[1] * 5)[:72]]
    want = dequant_acc_leaves(accs, wires, scales, 0.3)
    before = dequant_acc_leaves_kernel.launches
    got = dequant_acc_leaves_kernel(accs, wires, 0.3, scales)
    launched("dequant_acc", dequant_acc_leaves_kernel, before,
             -(-72 // MAX_LEAVES), "over 72 leaves")
    for g, wl in zip(got, want):
        held("dequant_acc", g, wl, True)
    acc = torch.randn((sizes[big],), generator=gen, device=dev)
    check(torch.equal(dequant_acc_leaves_kernel(
        [acc.clone(), torch.zeros((1,), device=dev)],
        [zero_wire, zero_wire[:1]], 0.3, [zero_scale, zero_scale])[0], acc),
        "dequant_acc table of an all-zero int8 leaf changed the accumulator")
    check(torch.equal(dequant_reduce_leaves_kernel(
        [torch.empty((sizes[big],), device=dev)], [[zero_wire] * CLIENTS], w,
        [[zero_scale] * CLIENTS])[0], torch.zeros((sizes[big],), device=dev)),
        "dequant_reduce table of an all-zero int8 leaf is not 0")

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
          f"fp32; {n_table['dequant_reduce']} table calls: a round's 15 "
          f"leaves of unstacked client wires in one launch, aligned and one "
          f"element off, equal to the one-leaf table over each stack bit for "
          f"bit; {REDUCE_CLIENTS + 5} and {2 * REDUCE_CLIENTS + 5} clients "
          f"in 16-client chunks, equal to one fmaf chain bit for bit), max "
          f"abs err {err['dequant_reduce']:.3e} (tolerance "
          f"{KERNEL_TOL}), two launches equal bit for bit; dequant_acc "
          f"{n_cases['dequant_acc']} leaf folds (largest leaf, a round's 60, "
          f"ragged; int8, fp16, fp32; {n_table['dequant_acc']} table calls: "
          f"a fold's 15 leaves a launch, aligned and one element off, 72 "
          f"leaves in two), equal bit for bit, max abs err "
          f"{err['dequant_acc']:.3e}; scatter_acc {n_cases['scatter_acc']} "
          f"leaf folds (K = 1% of each leaf, distinct: equal to index_add bit "
          f"for bit, one leaf a launch and a fold's 15 leaves a launch, 72 "
          f"leaves in two; colliding and out-of-range at tolerance), max abs "
          f"err "
          f"{err['scatter_acc']:.3e}; an all-zero int8 leaf (scale 1.0) "
          f"adds 0")

    rows = {}
    # row 4: a round's batched reduce: one launch over the unstacked client
    # wires (the main path), beside one launch a leaf over stacks made
    # beforehand; then, eager (the weights go to the card from the host,
    # which a CUDA graph cannot capture), the whole batched_reduce of a
    # round beside the parent's form of it: for each leaf a stack of the
    # wires and of the scales, the weights normalised and one launch
    for d in ("int8", "fp16", "fp32"):
        rnd = rounds[d]
        n_l = len(sizes)
        cases = [agg_case_rows(rnd, k) for k in range(n_l)]
        coefs = [torch.stack([w, sc], dim=1) for _, sc in cases]
        coef = [cf[:, 0] * cf[:, 1] for cf in coefs]
        xs = [x for x, _ in cases]
        wbl = [[client[k][0] for client in rnd] for k in range(n_l)]
        sbl = ([[client[k][1] for client in rnd] for k in range(n_l)]
               if d == "int8" else None)
        outs = [torch.empty((n,), device=dev) for n in sizes]
        t = time_variants({
            "kernel": lambda: dequant_reduce_leaves_kernel(outs, wbl, w, sbl),
            "per_leaf": lambda: [dequant_reduce_kernel(x, cf)
                                 for x, cf in zip(xs, coefs)],
            "plain": lambda: [dequant_reduce_ref(x, cf)
                              for x, cf in zip(xs, coefs)],
            "library": lambda: [k @ x.to(torch.float32)
                                for k, x in zip(coef, xs)]})
        encs = [client[:n_l] for client in rnd]
        template = {f"{k:02d}": torch.zeros((n,), device=dev)
                    for k, n in enumerate(sizes)}
        codec = "none" if d == "fp32" else d

        def stacked_round():
            wt = torch.tensor(w_host, dtype=torch.float32, device=dev)
            ones = torch.ones((CLIENTS,), dtype=torch.float32, device=dev)
            return [dequant_reduce_flat(
                torch.stack([e[k][0].reshape(-1) for e in encs]),
                torch.stack([e[k][1].reshape(()) for e in encs])
                if d == "int8" else ones, wt, use_kernel=True)
                for k in range(n_l)]

        t_round = time_variants({
            "round": lambda: batched_reduce(codec, encs, w_host, template,
                                            use_kernel=True),
            "stacked": stacked_round}, modes=("eager",))["eager"]
        nbytes = sum(x.numel() * x.element_size() + 4 * x.shape[1]
                     + cf.numel() * 4 for x, cf in zip(xs, coefs))
        bound, by = bound_ms(nbytes, sum(2 * x.numel() for x in xs))
        rows[("dequant_reduce", d)] = (t["device"], bound, by)
        print(f"dequant_reduce {d}, a round ({n_l} leaves, C = {CLIENTS}): "
              f"bound {bound:.5f} ms ({by}: {nbytes} B at 3.35 TB/s)")
        for mode, tm in t.items():
            print(f"  {mode:6s} kernel {tm['kernel']:.5f} ms (1 launch; one "
                  f"a leaf over stacks: {tm['per_leaf']:.5f} ms, {n_l} "
                  f"launches), plain {tm['plain']:.5f} ms, cast + coef @ "
                  f"wires {tm['library']:.5f} ms")
        print(f"  eager  batched_reduce of the round {t_round['round']:.5f} "
              f"ms; stacked per leaf, as before {t_round['stacked']:.5f} ms")
    # row 5: a round's streamed folds, in place: one launch a client's fold
    # over its 12 leaves (the main path), beside one launch a leaf
    for d in ("int8", "fp16"):
        rnd = rounds[d]
        accs = [torch.zeros((n,), device=dev) for n in sizes]
        folds = [(accs[k], client[k][0], w_host[ci], client[k][1],
                  w[ci] * (1.0 if client[k][1] is None else client[k][1]))
                 for ci, client in enumerate(rnd) for k in range(len(sizes))]
        tables = [([x for x, _ in client[:len(sizes)]], w_host[ci],
                   [sc for _, sc in client[:len(sizes)]]
                   if d == "int8" else None)
                  for ci, client in enumerate(rnd)]
        t = time_variants({
            "kernel": lambda: [dequant_acc_leaves_kernel(accs, xs, wc, scs)
                               for xs, wc, scs in tables],
            "per_leaf": lambda: [dequant_acc_kernel(a, x, wc, sc)
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
        print(f"dequant_acc {d}, a round's {len(tables)} folds of "
              f"{len(sizes)} leaves: bound {bound:.5f} ms ({by}: {nbytes} B "
              f"at 3.35 TB/s)")
        for mode, tm in t.items():
            print(f"  {mode:6s} kernel {tm['kernel']:.5f} ms "
                  f"({len(tables)} launches; one a leaf: "
                  f"{tm['per_leaf']:.5f} ms, {len(folds)} launches), plain "
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
        dequant_acc_leaves_kernel, dequant_reduce_leaves_kernel,
        scatter_acc_leaves_kernel)
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
    from repro_torch.kernels.fedavg.kernel import fedavg_leaves_kernel
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.wkv6.kernel import wkv6_kernel
    return {"fedavg": fedavg_leaves_kernel, "dp_clip": dp_clip_noise_kernel,
            "boundary_fuse": boundary_fuse_kernel,
            "dequant_reduce": dequant_reduce_leaves_kernel,
            "dequant_acc": dequant_acc_leaves_kernel,
            "scatter_acc": scatter_acc_leaves_kernel,
            "flash_attention": flash_attention_kernel,
            "wkv6": wkv6_kernel}


def drive_path(dev, label, over, expect):
    """One main path: ``train_epoch`` at full width, ROUNDS x BATCHES, with
    every kernel's launch count set to 0 just before and read just after.
    Checks finite losses, every parameter finite on the card, and each
    kernel's launches: ``expect[name]`` for the kernels the path runs, 0
    for every other (``expect`` may be a function of the trainer)."""
    from repro_torch.tree import leaves

    tr = full_width_trainer(over)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    hist, walls = [], WALLS.setdefault(label, [])
    for r in range(ROUNDS):
        t0 = time.perf_counter()
        m = tr.train_epoch(batches_per_client=BATCHES)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        hist.append(m)
        extra = "".join(f", {k} {m[k]:.6g}" for k in (
            "dp_epsilon", "lan_mbytes", "edge_mbytes", "codec_error")
            if k in m)
        print(f"{label} round {r}: wall {walls[-1]:.3f} s, "
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


def traced_kernels(fn):
    """``fn()`` under ``torch.profiler``: its kernels (the trace's events
    of category "kernel") and its wall time in seconds (profiler on)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e], wall


def busy_ms(kernels):
    """Device busy time: the union of the kernels' intervals (cuDNN
    overlaps some)."""
    busy, end = 0.0, float("-inf")
    for k in sorted(kernels, key=lambda k: k["ts"]):
        busy += max(0.0, k["ts"] + k["dur"] - max(k["ts"], end))
        end = max(end, k["ts"] + k["dur"])
    return busy / 1e3


def print_top_kernels(label, kernels, top):
    by_name = {}
    for k in kernels:
        n, t = by_name.get(k["name"], (0, 0.0))
        by_name[k["name"]] = (n + 1, t + k["dur"] / 1e3)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :top]:
        print(f"{label}:   {t:8.3f} ms in {n:5d} launches of "
              f"{name[:90]}")


def profile_round(tr, label, expect_fuse, top=0):
    """One more warm round of ``tr`` under ``torch.profiler``: the
    boundary_fuse launches in it (held to ``expect_fuse`` when the trace
    has kernels) and their device time, the time of all its kernels
    against the round's wall time (profiler on), and with ``top`` the
    kernels that took the most device time, summed by name."""
    kernels, wall = traced_kernels(
        lambda: tr.train_epoch(batches_per_client=BATCHES))
    if not kernels:
        print(f"{label}: the profiler traced no kernel; boundary_fuse device "
              f"time not measured")
        return None
    fuse = [k["dur"] for k in kernels if re.search(r"\bfuse<", k["name"])]
    check(len(fuse) == expect_fuse, f"{label}: {len(fuse)} boundary_fuse "
          f"kernels in the profiled round, expected {expect_fuse}")
    ms = sum(fuse) / 1e3
    busy = busy_ms(kernels)
    print(f"{label}: profiled round: boundary_fuse {len(fuse)} launches, "
          f"{ms:.4f} ms on the device ({ms / max(len(fuse), 1):.4f} ms a "
          f"launch); all {len(kernels)} kernels "
          f"{sum(k['dur'] for k in kernels) / 1e3:.3f} ms, busy {busy:.3f} "
          f"ms of a {wall * 1e3:.1f} ms round (busy share "
          f"{busy / wall / 1e3:.3f})")
    print_top_kernels(label, kernels, top)
    return ms


@fp32_convs
def time_per_example_steps(tr):
    """Full width, a batch of the client whose plan has the most
    boundaries: the per-example staged step through the split against the
    unsplit DP step's ``torch.func.vmap`` of per-example gradients, CUDA
    events around 5 calls each after a warm-up, in turns (unsplit, staged,
    staged, unsplit); the staged step's boundary_fuse launches a call."""
    import functools
    from repro_torch import keys
    from repro_torch.core.gan import d_loss_fn
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.tree import tree_map

    cid = max(tr.split_execs, key=lambda c: tr.split_execs[c].num_boundaries)
    ex = tr.split_execs[cid]
    params = tree_map(torch.Tensor.detach, tr.state.d_params[cid])
    real = tr._sample_real(cid, BATCH)
    fake = tr._gen(tr.state.g_params, tr._z(BATCH))
    key = keys.root(keys.DP_SGD, 0)
    loss_fn = functools.partial(d_loss_fn, c=tr.c)
    mono = torch.func.vmap(torch.func.grad_and_value(
        lambda p, r, f: loss_fn(p, r[None], f[None])), in_dims=(None, 0, 0))

    def unsplit():
        with torch.enable_grad():
            return mono(params, real, fake)

    def staged():
        return ex.per_example_value_and_grad(params, real, fake, key)

    before = boundary_fuse_kernel.launches
    staged()
    per_call = boundary_fuse_kernel.launches - before
    check(per_call == 4 * ex.num_boundaries,
          f"per-example step: {per_call} boundary_fuse launches, expected "
          f"{4 * ex.num_boundaries}")
    runs = {"unsplit": [], "staged": []}
    for name in ("unsplit", "staged", "staged", "unsplit"):
        runs[name].append(time_ms({"unsplit": unsplit,
                                   "staged": staged}[name], iters=5))
    t = {k: float(np.mean(v)) for k, v in runs.items()}
    print(f"per-example step at full width (B {BATCH}, {ex.num_boundaries} "
          f"boundaries): staged through the split {t['staged']:.2f} ms "
          f"({per_call} boundary_fuse launches), unsplit vmap "
          f"{t['unsplit']:.2f} ms, ratio {t['staged'] / t['unsplit']:.3f}")
    return t


@functools.lru_cache(maxsize=None)
def full_width_parts():
    """The main paths' client data: the paper's 24 batches x 256 examples
    per client, over CLIENTS Dirichlet partitions."""
    from repro_torch.data import partition_dirichlet, synthetic_mnist
    imgs, labels = synthetic_mnist(24 * BATCH * CLIENTS, seed=0)
    return partition_dirichlet(imgs, labels, CLIENTS, alpha=0.5, seed=0)


def full_width_trainer(over):
    """An ``FSLGANTrainer`` on dcgan-mnist at full width, on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gan import FSLGANTrainer
    cfg = get_config("dcgan-mnist").override(
        {"fed.kernel_aggregation": True, **over})
    c = cfg.model.dcgan
    check((cfg.fsl.num_clients, cfg.shape.global_batch, c.base_filters,
           c.latent_dim, cfg.optim.lr) == (CLIENTS, BATCH, 64, 100, 2e-4),
          "dcgan-mnist is not at full width")
    return FSLGANTrainer(cfg, full_width_parts(), seed=0)


def phase_main_paths(dev):
    from repro_torch.configs.registry import get_config
    from repro_torch.fed.transport import predict_codec_bytes
    from repro_torch.models.dcgan import disc_init
    from repro_torch.tree import leaves

    sizes = [l.numel() for l in leaves(disc_init(
        torch.Generator().manual_seed(0),
        get_config("dcgan-mnist").model.dcgan, "meta"))]
    reduce_round = ROUNDS                 # fedavg: one launch a round
    folds = CLIENTS * ROUNDS            # agg_fuse: one launch a client's fold
    launches = {}

    tr, _, counts = drive_path(dev, "main path", {},
                               {"fedavg": reduce_round})
    profile_round(tr, "main path", 0, top=6)
    launches["fedavg"] = counts["fedavg"]
    img = tr.generate(16)
    check(img.shape == (16, 28, 28, 1) and np.isfinite(img).all()
          and np.abs(img).max() <= 1.0, "generated images out of shape/range")

    tr, hist, _ = drive_path(
        dev, "dp-sgd path", DP_SGD,
        {"fedavg": reduce_round, "dp_clip": CLIENTS * BATCHES * ROUNDS})
    eps = [m["dp_epsilon"] for m in hist]
    check(all(math.isfinite(e) for e in eps) and eps[1] > eps[0] > 0,
          f"dp_epsilon not finite and growing: {eps}")
    profile_round(tr, "dp-sgd path", 0, top=6)
    launches["dp_clip"] = CLIENTS * BATCHES * ROUNDS

    def split_launches(tr):
        # 4 crossings a boundary a batch: the real and fake passes, forward
        # and backward
        return {"fedavg": reduce_round, "boundary_fuse": sum(
            4 * ex.num_boundaries * BATCHES * ROUNDS
            for ex in tr.split_execs.values())}

    tr, hist, counts = drive_path(dev, "split path", SPLIT,
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
    by_path = {"boundary_fuse": {"split path": want}}
    profile_round(tr, "split path", want // ROUNDS)

    # the pipelined split: each batch in PIPELINE_K micro-batches of
    # BATCH / PIPELINE_K, the staged chain once a micro-batch; the same
    # LAN bytes, the round priced by the 1F1B schedule's makespan
    def pipelined_launches(tr):
        check(tr._pipeline_k() == PIPELINE_K and all(
            ex.pipeline_microbatches == PIPELINE_K
            for ex in tr.split_execs.values()), "the split is not pipelined")
        return {"fedavg": reduce_round, "boundary_fuse": sum(
            4 * PIPELINE_K * ex.num_boundaries * BATCHES * ROUNDS
            for ex in tr.split_execs.values())}

    tr, phist, counts = drive_path(
        dev, "pipelined split path",
        {**SPLIT, "split.pipeline_microbatches": PIPELINE_K},
        pipelined_launches)
    for m, ms in zip(phist, hist):
        check(m["lan_mbytes"] == lan / 1e6,
              f"pipelined lan_mbytes {m['lan_mbytes']} != {lan / 1e6}")
        check(m["round_time_s"] < ms["round_time_s"],
              f"pipelined virtual round {m['round_time_s']} not below the "
              f"split path's {ms['round_time_s']}")
    print(f"pipelined split path: boundary_fuse 4 x {PIPELINE_K} x {bounds} "
          f"x {BATCHES} x {ROUNDS} = {counts['boundary_fuse']}, lan_mbytes "
          f"{lan / 1e6} as the split path, virtual round "
          f"{phist[-1]['round_time_s']} s against the split path's "
          f"{hist[-1]['round_time_s']} s")
    by_path["boundary_fuse"]["pipelined split path"] = counts["boundary_fuse"]
    profile_round(tr, "pipelined split path",
                  counts["boundary_fuse"] // ROUNDS)

    # DP-SGD through the split: the per-example staged step, one
    # amax="row" boundary_fuse launch a crossing for the whole batch, then
    # one dp_clip launch a step
    def dp_split_launches(tr):
        return {"fedavg": reduce_round,
                "dp_clip": CLIENTS * BATCHES * ROUNDS,
                "boundary_fuse": sum(4 * ex.num_boundaries * BATCHES * ROUNDS
                                     for ex in tr.split_execs.values())}

    tr, hist, counts = drive_path(dev, "dp-sgd split path",
                                  {**DP_SGD, **SPLIT},
                                  dp_split_launches)
    eps = [m["dp_epsilon"] for m in hist]
    check(all(math.isfinite(e) for e in eps) and eps[1] > eps[0] > 0,
          f"dp-sgd split: dp_epsilon not finite and growing: {eps}")
    for m in hist:
        check(m["lan_mbytes"] == lan / 1e6,
              f"dp-sgd split lan_mbytes {m['lan_mbytes']} != {lan / 1e6}")
    print(f"dp-sgd split path: boundary_fuse 4 x {bounds} x {BATCHES} x "
          f"{ROUNDS} = {counts['boundary_fuse']} (amax=row, one a crossing "
          f"for the whole batch), dp_clip {counts['dp_clip']}, epsilon "
          f"{eps}, lan_mbytes {lan / 1e6} as the split path")
    by_path["boundary_fuse"]["dp-sgd split path"] = counts["boundary_fuse"]
    by_path["dp_clip"] = {"dp-sgd path": launches["dp_clip"],
                          "dp-sgd split path": counts["dp_clip"]}
    profile_round(tr, "dp-sgd split path", counts["boundary_fuse"] // ROUNDS)
    time_per_example_steps(tr)
    del tr

    # the vectorized backend: the same five paths, the clients of a split
    # signature stacked under torch.func.vmap, one stacked step a batch,
    # the kernels called outside the vmap: dp_clip once a client a step,
    # boundary_fuse once a crossing a client (split, pipelined) or once a
    # crossing a signature group over its C x B rows (amax="row", DP-SGD
    # split); fedavg once a round, reading the stacked output's rows
    def dp_split_group_launches(tr):
        groups = {tr.program.signature_for(cid): ex.num_boundaries
                  for cid, ex in tr.split_execs.items()}
        print(f"vectorized dp-sgd split path: {len(groups)} signature "
              f"groups, boundaries {sorted(groups.values())}")
        return {"fedavg": reduce_round,
                "dp_clip": CLIENTS * BATCHES * ROUNDS,
                "boundary_fuse": 4 * sum(groups.values()) * BATCHES * ROUNDS}

    vec = {"fed.backend": "vectorized"}
    for name, over, expect in (
            ("", {}, {"fedavg": reduce_round}),
            ("dp-sgd ", DP_SGD, {"fedavg": reduce_round,
                                 "dp_clip": CLIENTS * BATCHES * ROUNDS}),
            ("split ", SPLIT, split_launches),
            ("pipelined split ",
             {**SPLIT, "split.pipeline_microbatches": PIPELINE_K},
             pipelined_launches),
            ("dp-sgd split ", {**DP_SGD, **SPLIT}, dp_split_group_launches)):
        label = f"vectorized {name}path"
        tr, hist, counts = drive_path(dev, label, {**over, **vec},
                                      expect)
        if "split.enabled" in over:
            check(all(m["lan_mbytes"] == lan / 1e6 for m in hist),
                  f"{label}: lan_mbytes {[m['lan_mbytes'] for m in hist]}")
        if "privacy.enabled" in over:
            eps = [m["dp_epsilon"] for m in hist]
            check(all(math.isfinite(e) for e in eps) and eps[1] > eps[0] > 0,
                  f"{label}: dp_epsilon not finite and growing: {eps}")
        for k, n in counts.items():
            if n:
                by_path.setdefault(k, {})[label] = n
        loop = WALLS["main path" if not name else f"{name}path"][-1]
        warm = WALLS[label][-1]
        print(f"{label}: warm round {warm:.3f} s against the loop path's "
              f"{loop:.3f} s in this run (ratio {warm / loop:.3f}), "
              f"launches {counts}")
        profile_round(tr, label, counts["boundary_fuse"] // ROUNDS, top=6)
        del tr

    # backend="auto" on the plain, split and dp-sgd split paths: the probe
    # runs both backends' round dispatch on zero batches, a warm-up and
    # AUTO_PROBE_RUNS timed runs each, then pins the faster for the
    # trainer's life.  The probe's dispatch launches the step's kernels
    # (not the reduce's), so each path's counts hold 1 + AUTO_PROBE_RUNS
    # loop and vectorized rounds' more
    from repro_torch.core.gan import AUTO_PROBE_RUNS
    probes = 1 + AUTO_PROBE_RUNS

    def auto_launches(loop_round, vec_round):
        def expect(tr):
            picked = {"loop": loop_round,
                      "vectorized": vec_round}[tr._auto_backend]
            counts = {k: probes * (loop_round.get(k, 0)
                                   + vec_round.get(k, 0))
                      + ROUNDS * picked.get(k, 0)
                      for k in set(loop_round) | set(vec_round)}
            return {**counts, "fedavg": reduce_round}
        return expect

    def per_round(expect):
        return lambda tr: {k: n // ROUNDS for k, n in expect(tr).items()
                           if k != "fedavg"}

    auto_picks = {}
    for name, over, loop_round, vec_round in (
            ("", {}, lambda tr: {}, lambda tr: {}),
            ("split ", SPLIT, per_round(split_launches),
             per_round(split_launches)),
            ("dp-sgd split ", {**DP_SGD, **SPLIT},
             per_round(dp_split_launches),
             per_round(dp_split_group_launches))):
        label = f"auto {name}path"
        tr, _, counts = drive_path(
            dev, label, {**over, "fed.backend": "auto"},
            lambda tr, lr=loop_round, vr=vec_round: auto_launches(
                lr(tr), vr(tr))(tr))
        probe = tr.feedback[0].backend_probe_us
        pick = tr._auto_backend
        check(pick in probe and set(probe) == {"loop", "vectorized"}
              and all(v > 0 for v in probe.values()),
              f"{label}: pick {pick}, probe {probe}")
        loop = WALLS["main path" if not name else f"{name}path"][-1]
        vec = WALLS[f"vectorized {name}path"][-1]
        faster = "loop" if loop <= vec else "vectorized"
        auto_picks[label] = (pick, faster)
        print(f"{label}: probe (round dispatch on zero batches, the "
              f"fastest of {AUTO_PROBE_RUNS} warm runs) loop "
              f"{probe['loop'] / 1e3:.1f} ms, vectorized "
              f"{probe['vectorized'] / 1e3:.1f} ms (ratio "
              f"{probe['vectorized'] / probe['loop']:.3f}); picked {pick}; "
              f"this run's warm rounds loop {loop:.3f} s, vectorized "
              f"{vec:.3f} s (ratio {vec / loop:.3f}, faster: {faster}); "
              f"auto's warm round {WALLS[label][-1]:.3f} s; launches "
              f"{counts}")
        for k, n in counts.items():
            if n and k != "fedavg":
                by_path.setdefault(k, {})[label] = n
        del tr
    print(f"auto picks (pick, faster warm round in this run): {auto_picks}")

    # fed.shard_clients on one card at full width: no mesh, one shard, and
    # under cuDNN's deterministic algorithms a round equal in every leaf
    # to the unsharded vectorized round
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        vec = {"fed.backend": "vectorized"}
        ta = full_width_trainer(vec)
        tb = full_width_trainer({**vec, "fed.shard_clients": True})
        check(tb._client_mesh() is None and tb._num_shards("vectorized")
              == 1, "shard_clients on one card built a mesh")
        ta.train_epoch(batches_per_client=BATCHES)
        tb.train_epoch(batches_per_client=BATCHES)
        sa, sb = ta.state, tb.state
        pairs = list(zip(leaves(sa.g_params), leaves(sb.g_params))) + [
            p for cid in sorted(sa.d_params)
            for p in zip(leaves(sa.d_params[cid]), leaves(sb.d_params[cid]))]
        check(all(torch.equal(a, b) for a, b in pairs),
              "shard_clients on one card differs from the unsharded round")
        print(f"full width, fed.shard_clients on one card: no mesh, 1 shard, "
              f"{len(pairs)} leaves of G and the {CLIENTS} Ds equal to the "
              f"unsharded vectorized round bit for bit (deterministic cuDNN, "
              f"1 round x {BATCHES} batches)")
        del ta, tb
    finally:
        torch.backends.cudnn.deterministic = saved

    # the compressed-domain server reduce: the fedavg kernel does not run
    # on the flat paths; every client's wire folds in one launch over its
    # leaves, or the round's wires reduce in one launch
    int8 = {"fed.codec": "int8"}
    for label, over, expect in (
            ("stream int8 path", {**int8, "fed.server_reduce": "stream"},
             {"dequant_acc": folds}),
            ("batched int8 path", {**int8, "fed.server_reduce": "batched"},
             {"dequant_reduce": ROUNDS}),               # one a round
            ("stream top-k path", {"fed.codec": "topk",
                                   "fed.server_reduce": "stream"},
             {"scatter_acc": folds})):
        tr, hist, _ = drive_path(dev, label, over, expect)
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
        {"dequant_acc": folds, "fedavg": reduce_round})
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

    # the edge hierarchy with the decode reduce: each cohort pre-reduces
    # its members' trees in one fedavg launch, the server averages the 2
    # aggregates in one more (3 a round)
    tr, hist, _ = drive_path(dev, "hierarchy decode path",
                             {"fed.hierarchy_cohorts": 2},
                             {"fedavg": 3 * ROUNDS})
    groups = tr.engine.hierarchy.group(tr.engine.roster)
    check(sorted(len(m) for m in groups.values()) == [2, 3],
          f"cohorts {groups}")
    live = tr.engine.last_report.peak_live_trees
    check(live == CLIENTS + 2, f"hierarchy decode: peak_live_trees {live}, "
          f"expected {CLIENTS + 2} (every member tree and the 2 aggregates)")
    return launches, by_path


# the adaptive path: the control plane, the flight recorder and the health
# monitors over DP-SGD through the executed split with the stream reduce
ADAPTIVE_ROUNDS = 3
ADAPTIVE = {
    **DP_SGD, **SPLIT,
    # the fused fp16+dp stage at every boundary, and the split controller's
    # int8+dp at the ones it finds leaky: both through boundary_fuse
    "split.boundary_stage": "fp16+dp",
    # random_single plans are imbalanced, so the split controller replans
    "fsl.selection": "random_single",
    "fed.server_reduce": "stream", "fed.codec": "int8",
    "control.mode": "adaptive",
    "control.controllers": ["codec", "sigma", "split", "deadline"],
    # codec: top-k's error (~0.9) is over the budget, int8's (~0.01) under
    "control.error_budget": 0.05,
    # sigma: 30 DP-SGD releases at q = 1 cost far more than 1.0 buys
    "control.epsilon_budget": 20.0,
    "control.horizon_rounds": ADAPTIVE_ROUNDS,
    # split: any imbalance replans; a raw boundary's dCor (~0.9+) leaks
    "control.imbalance_threshold": 1.01, "control.dcor_threshold": 0.3,
    "control.leaky_stage": "int8+dp", "control.probe_batch": 64,
    # deadline: the 0.9 quantile of the measured finishes, x 1.25
    "control.deadline_quantile": 0.9, "control.deadline_slack": 1.25,
    "obs.enabled": True, "obs.run_id": "adaptive",
    "obs.out_dir": os.path.join(ROOT, "build", "obs_runs"),
    "obs.health.enabled": True, "obs.health.policy": "record",
    "obs.profile_kernels": True,
}
# the knob fields each controller owns
CONTROLLER_KNOBS = {"codec": ("codec", "topk_frac"), "sigma": ("sigma",),
                    "split": ("split_strategy", "stage_by_boundary"),
                    "deadline": ("deadline_s",)}


def fused_kernel_stage(name):
    """Whether a boundary stage name runs through boundary_fuse."""
    parts = name.split("+")
    return len(parts) == 2 and parts[1] == "dp" \
        and parts[0] in ("fp16", "int8")


def adaptive_round_launches(tr, knobs, rep, profile):
    """What one adaptive round launches, from the knobs in force and the
    clients that ran and landed (``rep``): dp_clip once a DP-SGD step of
    each client that ran; boundary_fuse 4 times a fused boundary a step
    (the real and fake passes, forward and backward) on each such
    client's plan under the knobs' strategy, each boundary's stage from
    the knobs' map or the config's; one stream fold a landed client,
    scatter_acc under top-k, dequant_acc under a dense codec; and the
    profile's launches (its first call and each timed one, for every
    kernel it ran) in the round that wrote ``profile.json``."""
    from repro_torch.core.selection import plan_all_clients
    from repro_torch.core.split import plan_segments
    cfg = tr.cfg
    plans = plan_all_clients(tr.pool, tr._layers, knobs.split_strategy,
                             cfg.fsl.seed)
    base = cfg.split.boundary_stage
    ran = [cid for cid, _ in rep.client_infos]
    want = {"dp_clip": len(ran) * BATCHES, "boundary_fuse": 0,
            "scatter_acc": 0, "dequant_acc": 0}
    for cid in ran:
        nb = len(plan_segments(plans[cid])) - 1
        fused = sum(fused_kernel_stage((knobs.stage_by_boundary or {}).get(
            b, base)) for b in range(nb))
        want["boundary_fuse"] += 4 * fused * BATCHES
    fold = "scatter_acc" if knobs.codec == "topk" else "dequant_acc"
    want[fold] += len(rep.participated)
    kernel_of = {"fedavg": "fedavg", "dp": "dp_clip",
                 "boundary": "boundary_fuse", "agg": "dequant_reduce"}
    for name, p in (profile or {}).items():
        check(p["kernel"], f"profile {name} did not run its kernel")
        k = kernel_of[name.split("_")[0]]
        want[k] = want.get(k, 0) + 1 + p["runs"]
    return want


def phase_adaptive_path(dev):
    """The control plane, the flight recorder and the health monitors at
    full width: ``FSLGANTrainer.train_epoch`` for ADAPTIVE_ROUNDS rounds x
    BATCHES batches under ``control.mode="adaptive"`` (all four
    controllers), DP-SGD through the executed split with the dp_clip and
    boundary_fuse kernels, the stream reduce through agg_fuse, the
    recorder with trace, digests and the kernel profile, and the monitors
    under ``policy="record"``.  Checks each round's launches against the
    knobs in force and the clients that ran and landed, that every
    controller acted, that the recording replays to the same knobs, that
    the trace is valid Chrome-trace JSON; prints profile.json beside the
    H100 roofline terms.  Returns the launch counts."""
    from repro_torch.control import knobs_from_config
    from repro_torch.obs import (HealthMonitor, load_run, replay_run,
                                 state_digest, validate_chrome_trace)

    print("adaptive path settings: " + ", ".join(
        f"{k}={v}" for k, v in sorted(ADAPTIVE.items())
        if k.startswith(("control.", "privacy.", "split.", "fed.", "fsl.",
                         "obs."))))
    # the recorder appends to its logs: start from an empty run directory
    shutil.rmtree(os.path.join(ADAPTIVE["obs.out_dir"], "adaptive"),
                  ignore_errors=True)
    tr = full_width_trainer(ADAPTIVE)
    run_dir = tr.recorder.run_dir
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    total = {k: 0 for k in wrappers}
    prev = knobs_from_config(tr.cfg)
    acted = {name: [] for name in CONTROLLER_KNOBS}
    walls = WALLS.setdefault("adaptive path", [])
    profile = None
    for r in range(ADAPTIVE_ROUNDS):
        before = {k: w.launches for k, w in wrappers.items()}
        t0 = time.perf_counter()
        m = tr.train_epoch(batches_per_client=BATCHES)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = {k: w.launches - before[k] for k, w in wrappers.items()}
        k, rep = tr.knobs, tr.engine.last_report
        if r == 0:
            with open(os.path.join(run_dir, "profile.json")) as f:
                profile = json.load(f)
        want = adaptive_round_launches(tr, k, rep,
                                       profile if r == 0 else None)
        want = {name: want.get(name, 0) for name in got}
        check(got == want, f"adaptive round {r}: launches {got}, the knobs "
              f"and clients give {want}")
        for name, fields in CONTROLLER_KNOBS.items():
            if any(getattr(k, f) != getattr(prev, f) for f in fields):
                acted[name].append(r)
        prev = k
        for name, n in got.items():
            total[name] += n
        check(math.isfinite(m["d_loss"]) and math.isfinite(m["g_loss"]),
              f"adaptive round {r}: non-finite loss {m}")
        stages = dict(sorted((k.stage_by_boundary or {}).items()))
        print(f"adaptive round {r}: wall {walls[-1]:.3f} s, knobs codec "
              f"{k.codec}, sigma {k.sigma!r}, strategy {k.split_strategy}, "
              f"stages {stages or tr.cfg.split.boundary_stage + ' (all)'}, "
              f"deadline {k.deadline_s!r} s; ran {len(rep.client_infos)}, "
              f"landed {len(rep.participated)}, stragglers "
              f"{len(rep.stragglers)}; d_loss {m['d_loss']:.6f}, epsilon "
              f"{m['dp_epsilon']:.6g}, codec_error {m['codec_error']:.4g}; "
              f"launches {got} as the knobs give")
    print(f"adaptive path: controllers acted in rounds {acted}")
    for name, rounds in acted.items():
        check(rounds, f"the {name} controller never changed its knob")
    check(all(fb.dp_epsilon <= ADAPTIVE["control.epsilon_budget"]
              for fb in tr.feedback), "the sigma controller overspent")
    check(not [a for a in tr.health_alerts if a.severity == "fatal"],
          f"fatal health alerts: {tr.health_alerts}")

    res = replay_run(run_dir)
    check(res.matches, f"replay differs from the live knobs: {res.diff()}")
    rec = load_run(run_dir)
    check(len(rec.knobs) == ADAPTIVE_ROUNDS, "recorded knobs incomplete")
    with open(os.path.join(run_dir, "trace.json")) as f:
        n_events = validate_chrome_trace(json.load(f))
    cats = sorted({s.cat for s in tr.recorder.tracer.spans})
    check({"round", "client", "batch", "boundary", "uplink",
           "aggregate"} <= set(cats), f"trace categories {cats}")
    print(f"adaptive path: replay of {len(rec.feedback)} recorded rounds "
          f"gives the live knobs bit for bit; trace.json valid, {n_events} "
          f"complete events ({', '.join(cats)}); {len(rec.digests)} digests, "
          f"{len(rec.alerts)} alerts (policy record)")
    # what the layers this path adds cost a round, each timed once on the
    # final state, the device synchronised around it
    st, fb = tr.state, tr.feedback[-1]
    d0 = st.d_params[tr._active_clients()[0]]
    costs = {
        "state digest": lambda: state_digest(
            d0, st.d_opt, st.g_params, st.g_opt, round_index=fb.round_index),
        "dCor probe": tr._probe_boundary_dcor,
        "health checks": lambda: HealthMonitor(tr.cfg.obs.health)
        .check_round(fb, params=d0, update_base=d0),
        "trace export": lambda: (tr.recorder.tracer.record(
            "probe", cat="round", track="server", v_start=0.0, v_end=0.0),
            tr.recorder.flush()),
        # what a split knob change costs before its round: the split
        # programs rebuilt (wire bytes measured a signature) and the
        # engine repriced
        "split regroup": lambda: (tr._build_split_programs(),
                                  setattr(tr, "engine", None),
                                  tr._ensure_engine(BATCHES)),
    }
    spent = {}
    for name, fn in costs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        spent[name] = 1e3 * (time.perf_counter() - t0)
    print("adaptive path: a round's added host work, once each on the final "
          "state: " + ", ".join(f"{k} {v:.1f} ms" for k, v in spent.items()))
    for name, p in profile.items():
        print(f"  profile {name}: run {1e3 * p['run_s']:.4f} ms (best of "
              f"{p['runs']}, CUDA events), first call {p['compile_s']:.3f} s; "
              f"H100 roofline: {p['bytes_accessed']:.0f} B, "
              f"{p['flops']:.0f} flop, bound {1e3 * p['bound_s']:.4f} ms "
              f"({p['bound_by']}), {p['bound_s'] / p['run_s']:.3f} of it")
    print(f"adaptive path: {ADAPTIVE_ROUNDS} rounds x {BATCHES} batches x "
          f"{CLIENTS} clients, launches {total}")
    return total


def phase_small_adaptive_reference(dev):
    """On the card at a small width, each round equal bit for bit under
    cuDNN's deterministic algorithms: ``control.mode="frozen"`` (every
    controller named) against no control section, obs on (trace, digests,
    the kernel profile) against obs off, and the monitors under
    ``policy="record"`` against none — on the adaptive path's DP-SGD split
    stream configuration, with its kernels."""
    from repro_torch.tree import leaves
    small_over = {k: v for k, v in ADAPTIVE.items()
                  if not k.startswith(("control.", "obs."))}
    frozen = {"control.mode": "frozen", "control.controllers":
              ADAPTIVE["control.controllers"],
              "control.epsilon_budget": 20.0, "control.horizon_rounds": 2}
    obs = {"obs.enabled": True, "obs.run_id": "small-obs",
           "obs.out_dir": ADAPTIVE["obs.out_dir"],
           "obs.profile_kernels": True}
    record = {"obs.health.enabled": True, "obs.health.policy": "record"}
    shutil.rmtree(os.path.join(obs["obs.out_dir"], obs["obs.run_id"]),
                  ignore_errors=True)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, over in (("control frozen", frozen), ("obs on", obs),
                            ("health record", record)):
            ta = small_trainer(small_over)
            tb = small_trainer({**small_over, **over})
            for r in range(ROUNDS):
                ma = ta.train_epoch(batches_per_client=BATCHES)
                mb = tb.train_epoch(batches_per_client=BATCHES)
                check(ma == mb, f"{label}: round {r} metrics differ: "
                      f"{ma} != {mb}")
            pairs = [p for a, b in ((ta.state.g_params, tb.state.g_params),
                                    (ta.state.d_params, tb.state.d_params),
                                    (ta.state.d_opt, tb.state.d_opt))
                     for p in zip(leaves(a), leaves(b))]
            check(all(torch.equal(a, b) for a, b in pairs),
                  f"{label}: parameters differ from the plain run")
            check(tb.knobs == ta.knobs, f"{label}: knobs moved")
            print(f"small adaptive reference, {label}: {ROUNDS} rounds equal "
                  f"to the run without it bit for bit ({len(pairs)} leaves "
                  f"of G, the Ds and their optimizer states, and the "
                  f"metrics; deterministic cuDNN)")
    finally:
        torch.backends.cudnn.deterministic = saved


ATTACK_STEPS = 200              # gradient-inversion steps, clean and defended
PROFILED_STEPS = 10             # of them, again under torch.profiler
DECODER = dict(width=32, steps=150, batch=32)
SHADOW, VICTIMS = 1024, 256     # the decoder's shadow images, its victims
ROSTER = dict(population=1_000_000, participants=16, cohorts=4)
CKPT_DIR = os.path.join(ROOT, "build", "ckpt")


def bits_equal(a, b):
    """Equal bit for bit (also -0.0 against 0.0, and NaN payloads)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.reshape(-1).view(ints[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def phase_attack_path(dev):
    """The privacy attacks, checkpoints and the lazy roster at full width
    (dcgan-mnist, 5 clients, batch 256, base_filters 64: a D of 1,030,913
    parameters) on the repo's synthetic MNIST: gradient inversion of the
    plain path's trained D (ATTACK_STEPS steps on the victim shape (1, 28,
    28, 1)); the defended re-attack through the dp_clip kernel (1 launch,
    held against the plain version); activation inversion of the tensors
    an int8+dp split ships through the boundary_fuse kernel after one
    round, at every boundary of the client with the most (4 x (b + 1)
    launches at boundary b), beside the clean depth sweep; membership
    inference; the trainer's whole state saved and restored onto the card
    bit for bit; and a roster round's two-tier reduce through the fedavg
    kernel (4 cohorts + the WAN average: 5 launches) against the flat
    weighted FedAvg.  Every step's launches are set to 0 just before it
    and checked just after.  Returns the launch counts."""
    import functools
    from repro_torch import keys
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.core.gan import d_loss_fn
    from repro_torch.data import synthetic_mnist
    from repro_torch.device import fp32_convolutions
    from repro_torch.examples.privacy_frontier_demo import per_example_grads
    from repro_torch.fed.hierarchy import HierarchicalAggregator
    from repro_torch.fed.roster import Roster
    from repro_torch.kernels.dp_clip.ops import (dp_clip_noise_tree,
                                                 flatten_per_example)
    from repro_torch.kernels.dp_clip.ref import dp_clip_noise_ref
    from repro_torch.kernels.fedavg.ops import fedavg_trees
    from repro_torch.kernels.fedavg.ref import fedavg_leaves_ref
    from repro_torch.privacy import (ActivationInversionAttack,
                                     best_match_psnr, distance_correlation,
                                     invert_gradients, make_prefix_fn,
                                     make_shipped_prefix_fn,
                                     membership_inference, psnr, ssim)
    from repro_torch.tree import leaves, tree_map, unflatten_like

    wrappers = kernel_wrappers()
    total = {k: 0 for k in wrappers}

    def counted(label, fn, expect):
        """``fn()`` with every launch count set to 0 just before and read
        just after: each must be ``expect``'s (0 where it names none)."""
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: w.launches for k, w in wrappers.items()}
        want = {k: expect.get(k, 0) for k in got}
        check(got == want, f"attack path, {label}: launches {got}, expected "
              f"{want}")
        for k, n in got.items():
            total[k] += n
        return out, wall

    # the victim's D: the plain main path's configuration, trained the
    # same way (ROUNDS x BATCHES)
    tr = full_width_trainer({})
    for _ in range(ROUNDS):
        tr.train_epoch(batches_per_client=BATCHES)
    c, params = tr.c, tr.state.d_params["c0"]
    n_params = sum(l.numel() for l in leaves(params))
    check(n_params == 1_030_913, f"the D has {n_params} parameters")
    loss_fn = functools.partial(d_loss_fn, c=c)

    # 1. gradient inversion of the victim's D gradient
    victim = torch.as_tensor(tr.client_data["c0"][:1], device=dev)
    fake = 0.3 * keys.normal(keys.root(keys.DEFAULT, 3), victim.shape, dev)
    with fp32_convolutions(), torch.enable_grad():
        grad = torch.func.grad(loss_fn)(params, victim, fake)
    (rec, hist), wall = counted("gradient inversion", lambda: invert_gradients(
        loss_fn, params, grad, fake, victim.shape, steps=ATTACK_STEPS,
        key=keys.root(keys.DEFAULT, 7)), {})
    check(rec.shape == victim.shape and bool(torch.isfinite(rec).all())
          and float(rec.abs().max()) <= 1.0, "gradient inversion: the "
          "reconstruction is not finite images in [-1, 1]")
    check(all(math.isfinite(h) for h in hist), "non-finite matching loss")
    clean_psnr = best_match_psnr(rec, victim)
    print(f"attack path, gradient inversion (D of {n_params} parameters, "
          f"victim {tuple(victim.shape)}): {ATTACK_STEPS} steps in "
          f"{wall:.3f} s, {1e3 * wall / ATTACK_STEPS:.3f} ms a step, "
          f"matching loss {hist[0]:.4f} -> {hist[-1]:.4f}, PSNR "
          f"{clean_psnr:.3f} dB, SSIM {ssim(rec, victim):.4f}; launches 0")
    kernels, pwall = traced_kernels(lambda: invert_gradients(
        loss_fn, params, grad, fake, victim.shape, steps=PROFILED_STEPS,
        x0=rec))
    if kernels:
        busy = busy_ms(kernels)
        print(f"attack path, {PROFILED_STEPS} profiled inversion steps: "
              f"{len(kernels) / PROFILED_STEPS:.1f} kernels a step, busy "
              f"{busy / PROFILED_STEPS:.3f} ms of "
              f"{1e3 * pwall / PROFILED_STEPS:.3f} ms a step (busy share "
              f"{busy / pwall / 1e3:.3f}, profiler on)")
        print_top_kernels("attack path", kernels, 5)
    else:
        print("attack path: the profiler traced no kernel; the inversion "
              "step's device time not measured")

    # 2. the defended re-attack: the per-example gradient through dp_clip
    per_ex = per_example_grads(loss_fn, params, victim, fake)
    flat, _ = flatten_per_example(per_ex)
    check(tuple(flat.shape) == (1, n_params), f"per-example stack "
          f"{tuple(flat.shape)}")
    dp_key = keys.root(keys.DEFAULT, 11)
    g_dp, wall = counted("dp_clip", lambda: dp_clip_noise_tree(
        per_ex, 1.0, 1.0, dp_key, use_kernel=True), {"dp_clip": 1})
    want = dp_clip_noise_ref(flat, 1.0, 1.0, keys.normal(
        dp_key, (n_params,), dev))
    got = torch.cat([l.reshape(-1) for l in leaves(g_dp)])
    torch.testing.assert_close(got, want, **KERNEL_TOL)
    err = float((got - want).abs().max())
    (rec_dp, hist_dp), wall = counted("defended inversion", lambda:
                                      invert_gradients(
        loss_fn, params, g_dp, fake, victim.shape, steps=ATTACK_STEPS,
        key=keys.root(keys.DEFAULT, 7)), {})
    check(all(math.isfinite(h) for h in hist_dp), "non-finite matching loss")
    print(f"attack path, defended re-attack: dp_clip over (1, {n_params}) "
          f"(1 launch) vs plain max abs err {err:.3e} (tolerance "
          f"{KERNEL_TOL}); {ATTACK_STEPS} steps in {wall:.3f} s, matching "
          f"loss {hist_dp[-1]:.4f}, PSNR {best_match_psnr(rec_dp, victim):.3f}"
          f" dB (undefended {clean_psnr:.3f} dB)")

    # 3. activation inversion of what an executed split ships
    trs = full_width_trainer(SPLIT)
    trs.train_epoch(batches_per_client=BATCHES)
    cid = max(trs._active_clients(),
              key=lambda k: trs.split_execs[k].num_boundaries)
    ex, dparams = trs.split_execs[cid], trs.state.d_params[cid]
    aux = torch.as_tensor(synthetic_mnist(SHADOW, seed=5)[0], device=dev)
    victims = torch.as_tensor(synthetic_mnist(VICTIMS, seed=9)[0],
                              device=dev)

    def attack(prefix):
        atk = ActivationInversionAttack(prefix, (28, 28, 1),
                                        width=DECODER["width"], device=dev)
        h = atk.train(aux, steps=DECODER["steps"], batch=DECODER["batch"])
        recon = atk.reconstruct(victims)
        check(bool(torch.isfinite(recon).all()) and all(
            math.isfinite(v) for v in h), "non-finite decoder")
        return (h, psnr(recon, victims),
                distance_correlation(victims, prefix(victims)))

    for b in range(ex.num_boundaries):
        prefix = make_shipped_prefix_fn(ex, dparams, b,
                                        key=keys.root(keys.STAGE, 13))
        (h, p, dcor), wall = counted(
            f"shipped boundary {b}", lambda: attack(prefix),
            {"boundary_fuse": 4 * (b + 1)})
        print(f"attack path, activation inversion of {cid}'s shipped "
              f"boundary {b} (depth {ex.boundaries[b].depth}, "
              f"{trs.cfg.split.boundary_stage} through the kernel): decoder "
              f"loss {h[0]:.4f} -> {h[-1]:.4f}, PSNR {p:.3f} dB, dCor "
              f"{dcor:.4f} over {VICTIMS} victims; boundary_fuse "
              f"{4 * (b + 1)} launches; {wall:.3f} s")
    for depth in (1, 2, 3):
        (h, p, dcor), wall = counted(
            f"clean depth {depth}",
            lambda: attack(make_prefix_fn(dparams, c, depth)), {})
        print(f"attack path, activation inversion of the clean prefix at "
              f"depth {depth}: decoder loss {h[-1]:.4f}, PSNR {p:.3f} dB, "
              f"dCor {dcor:.4f}; {wall:.3f} s")

    # 4. membership inference on the trained D
    nonmembers = synthetic_mnist(256, seed=99)[0]
    mi, _ = counted("membership", lambda: membership_inference(
        params, c, tr.client_data["c0"][:256], nonmembers), {})
    check(0.0 <= mi["auc"] <= 1.0 and 0.0 <= mi["advantage"] <= 1.0,
          f"membership {mi}")
    print(f"attack path, membership inference (256 of c0's training images "
          f"vs 256 fresh): AUC {mi['auc']:.4f}, advantage "
          f"{mi['advantage']:.4f}")

    # 5. the trainer's state through a checkpoint, onto the card
    st = tr.state
    state = {"d_params": st.d_params, "d_opt": st.d_opt,
             "g_params": st.g_params, "g_opt": st.g_opt}
    os.makedirs(CKPT_DIR, exist_ok=True)
    path = os.path.join(CKPT_DIR, "state.npz")
    _, save_s = counted("checkpoint save",
                        lambda: save_pytree(path, state, {"step": st.step}),
                        {})
    (back, extra), load_s = counted("checkpoint load",
                                    lambda: load_pytree(path, like=state), {})
    pairs = list(zip(leaves(state), leaves(back)))
    check(extra == {"step": st.step} and all(
        b.device == a.device and bits_equal(a, b) for a, b in pairs),
          "the restored state differs from the saved one")
    nbytes = os.path.getsize(path)
    print(f"attack path, checkpoint of the trainer's state ({len(pairs)} "
          f"leaves: {CLIENTS} Ds and their Adam states, G and its): "
          f"{nbytes} bytes, save {save_s:.3f} s, load onto {dev} "
          f"{load_s:.3f} s, equal bit for bit")

    # 6. a roster round's two-tier reduce through the fedavg kernel
    roster = Roster(ROSTER["population"],
                    participants=ROSTER["participants"],
                    cohorts=ROSTER["cohorts"], seed=0)
    ids = roster.sample_round(0).client_ids
    updates = {}
    for i, cid_ in enumerate(ids):
        rng = np.random.default_rng(i)
        updates[f"v{cid_}"] = (tree_map(lambda p: p + torch.from_numpy(
            (1e-2 * rng.standard_normal(tuple(p.shape))).astype(
                np.float32)).to(dev), params), float(1 + i % 3))
    agg = HierarchicalAggregator(ROSTER["cohorts"], use_kernel=True,
                                 cohort_of=roster.cohort_of_cid)

    def two_tier():
        reds = agg.reduce_all(updates)
        return reds, fedavg_trees([r.aggregate for r in reds],
                                  [r.weight for r in reds])

    (reds, out), wall = counted("roster reduce", two_tier, {"fedavg": 5})
    w = torch.tensor([u[1] for u in updates.values()], device=dev)
    flat_avg = unflatten_like(params, fedavg_leaves_ref(
        [leaves(u[0]) for u in updates.values()], w / w.sum()))
    diff = max(float((a - b).abs().max())
               for a, b in zip(leaves(out), leaves(flat_avg)))
    for a, b in zip(leaves(out), leaves(flat_avg)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    big = Roster(10**9, participants=64, cohorts=8, seed=0)
    t0 = time.perf_counter()
    big.sample_round(0)
    sample_ms = 1e3 * (time.perf_counter() - t0)
    print(f"attack path, roster ({roster.population} clients, "
          f"{roster.participants} a round in {roster.cohorts} cohorts of "
          f"{[len(r.members) for r in reds]}): the two-tier reduce of "
          f"{len(updates)} full-width Ds (fedavg 5 launches, {wall:.3f} s) "
          f"vs the flat weighted FedAvg (plain): max abs diff {diff:.3e} "
          f"(rtol 1e-5, atol 1e-6); sampling a round of 10**9 clients "
          f"{sample_ms:.3f} ms")
    print(f"attack path: launches {total}")
    return total


def phase_small_attack_reference(dev):
    """On the card at a small width (base_filters 8, a plan of 3
    boundaries): the shipped prefix through the boundary_fuse kernel
    against ``split.use_kernel`` off at each boundary, within one int8
    quantum (b + 1 launches at boundary b); 5 gradient-inversion steps on
    the card against the same 5 on the CPU, within 1e-4 (the port's
    fp32-convolution guard on); and ``split_forward`` with its boundary
    hook against the unsplit forward, bit for bit under deterministic
    cuDNN."""
    import functools
    from repro_torch import keys
    from repro_torch.config import DCGANConfig
    from repro_torch.core import split as ts
    from repro_torch.core.devices import Client, Device
    from repro_torch.core.gan import bce_logits, d_loss_fn
    from repro_torch.core.selection import make_plan
    from repro_torch.device import fp32_convolutions
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.models.dcgan import (disc_apply, disc_apply_layer,
                                          disc_init, disc_layer_costs,
                                          disc_layer_names)
    from repro_torch.privacy import (invert_gradients, make_prefix_fn,
                                     make_shipped_prefix_fn)
    from repro_torch.tree import tree_map

    c = DCGANConfig(base_filters=8)
    costs = disc_layer_costs(c)
    plan = make_plan(Client("c0", [Device("d0", 1.0, 2),
                                   Device("d1", 2.0, 2)]),
                     [(n, costs[n]) for n in disc_layer_names(c)],
                     "sorted_single", 3)
    tails = (functools.partial(bce_logits, target=1.0),
             functools.partial(bce_logits, target=0.0))

    def execution(use_kernel):
        return ts.SplitExecution(
            plan, functools.partial(disc_apply_layer, c=c), tails,
            stage=ts.FusedBoundaryStage("int8", 1.0, 0.5,
                                        use_kernel=use_kernel))

    params = disc_init(torch.Generator().manual_seed(0), c, dev)
    rng = np.random.default_rng(17)
    x = torch.tensor(np.tanh(2 * rng.standard_normal((8, 28, 28, 1))),
                     dtype=torch.float32, device=dev)
    kern, plain = execution(True), execution(False)
    check(kern.num_boundaries == 3, "the plan is not 3 boundaries")
    key = keys.root(keys.STAGE, 3)
    worst = []
    for b in range(kern.num_boundaries):
        before = boundary_fuse_kernel.launches
        got = make_shipped_prefix_fn(kern, params, b, key=key)(x)
        torch.cuda.synchronize()
        check(boundary_fuse_kernel.launches - before == b + 1,
              f"shipped prefix at boundary {b}: "
              f"{boundary_fuse_kernel.launches - before} launches")
        want = make_shipped_prefix_fn(plain, params, b, key=key)(x)
        # the pre-stage tensor of the plain path's crossing, for its quantum
        pre = x if b == 0 else plain.forward_boundaries(
            params, x, key=keys.fold_in(key, 0), upto=b - 1)[b - 1]
        for n in plain.segments[b][1]:
            pre = plain.apply_layer(n, params, pre)
        quantum = float(pre.abs().max()) / 127
        diff = float((got - want).abs().max())
        check(diff <= quantum + 1e-5, f"shipped prefix at boundary {b}: "
              f"kernel vs plain {diff} > one int8 quantum {quantum}")
        worst.append((diff, quantum))
    print("small attack reference, shipped prefix (int8+dp) through the "
          "kernel vs plain, b + 1 launches at boundary b: max abs diff / "
          "int8 quantum " + ", ".join(f"b{b} {d:.3e} / {q:.3e}"
                                      for b, (d, q) in enumerate(worst)))

    cpu = torch.device("cpu")
    loss_fn = functools.partial(d_loss_fn, c=c)
    p_cpu = disc_init(torch.Generator().manual_seed(0), c, cpu)
    real = np.tanh(rng.standard_normal((1, 28, 28, 1))).astype(np.float32)
    fake = (0.3 * rng.standard_normal((1, 28, 28, 1))).astype(np.float32)
    x0 = (0.1 * rng.standard_normal((1, 28, 28, 1))).astype(np.float32)
    target = torch.func.grad(loss_fn)(p_cpu, torch.tensor(real),
                                      torch.tensor(fake))
    (xc, hc), (xg, hg) = (invert_gradients(
        loss_fn, p, tree_map(lambda t: t.to(d), target), fake,
        (1, 28, 28, 1), steps=5, x0=x0) for d, p in ((cpu, p_cpu),
                                                     (dev, params)))
    hdiff = max(abs(a - b) / abs(b) for a, b in zip(hg, hc))
    xdiff = float((xg.cpu() - xc).abs().max())
    check(hdiff <= 1e-4 and xdiff <= 1e-4, f"5 inversion steps on the card "
          f"vs the CPU: history {hdiff}, images {xdiff}")
    print(f"small attack reference, 5 gradient-inversion steps on the card "
          f"vs the CPU: history max rel diff {hdiff:.3e}, images max abs "
          f"diff {xdiff:.3e} (tolerance 1e-4)")

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad(), fp32_convolutions():
            apply_layer = lambda n, a: disc_apply_layer(  # noqa: E731
                n, params, a, c)
            seen = ts.boundary_activations(x, plan, apply_layer)
            out = ts.split_forward(x, plan, apply_layer,
                                   boundary_hook=lambda *a: None)
            check(torch.equal(out, disc_apply(params, x, c)),
                  "split_forward differs from the unsplit forward")
            for i, _, _, act in seen:
                check(torch.equal(act, make_prefix_fn(
                    params, c, kern.boundaries[i].depth)(x)),
                      f"boundary {i}'s hook activation differs from the "
                      f"prefix")
    finally:
        torch.backends.cudnn.deterministic = saved
    print(f"small attack reference, split_forward with its hook vs the "
          f"unsplit forward: equal bit for bit, and the {len(seen)} hook "
          f"activations equal to the clean prefixes (deterministic cuDNN)")


def adam_reach(beta1, beta2, steps):
    """The most bias-corrected Adam can move one element in ``steps``
    steps, in units of lr.  Step t moves it by |m_t / (1 - beta1^t)| /
    (sqrt(v_t / (1 - beta2^t)) + eps); by Cauchy-Schwarz over the moments'
    weights a_i, b_i of the gradients g_1..g_t that is at most
    sqrt(sum a_i^2 / b_i), which exceeds 1 from the second step on when
    beta1^2 < beta2: 1.054 at step 2 and 4.416 over 4 steps for (0.5,
    0.999), not the 4 of lr x steps."""
    reach = 0.0
    for t in range(1, steps + 1):
        a = [(1 - beta1) * beta1 ** (t - i) / (1 - beta1 ** t)
             for i in range(1, t + 1)]
        b = [(1 - beta2) * beta2 ** (t - i) / (1 - beta2 ** t)
             for i in range(1, t + 1)]
        reach += math.sqrt(sum(x * x / y for x, y in zip(a, b)))
    return reach


def compare_states(label, ta, tb, start):
    """G and client 0's D of two small trainers that took the same steps
    from the same ``start`` leaves: every leaf within 1e-4 absolute, except
    the BN-fed biases, which must each stay within the most Adam can move
    an element in that many steps (``adam_reach``) of their start.
    Returns the other leaves' largest difference, and the BN-fed biases'
    largest move and Adam's reach, both in units of lr."""
    from repro_torch.tree import leaves
    opt = ta.cfg.optim
    drift = opt.lr * adam_reach(opt.beta1, opt.beta2, ROUNDS * BATCHES)
    worst, moved_most = 0.0, 0.0
    start = list(start)
    for tree_a, tree_b in ((ta.state.g_params, tb.state.g_params),
                           (ta.state.d_params["c0"], tb.state.d_params["c0"])):
        for p, a, b in zip(paths(tree_a), leaves(tree_a), leaves(tree_b)):
            s = start.pop(0)
            if p[-2:] in BN_FED_BIASES:
                for side in (a, b):
                    moved = float((side - s).abs().max())
                    moved_most = max(moved_most, moved / opt.lr)
                    check(moved <= drift, f"{label}: {p} moved {moved:.4e}, "
                          f"beyond Adam's reach {drift:.4e}")
            else:
                d = float((a - b).abs().max())
                worst = max(worst, d)
                check(d <= 1e-4, f"{label}: {p} differs by {d}")
    return worst, moved_most, drift / opt.lr


def small_trainer(over, clients=2):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gan import FSLGANTrainer
    from repro_torch.data import partition_dirichlet, synthetic_mnist

    small = {"shape.global_batch": 8, "fsl.num_clients": clients,
             "model.dcgan.base_filters": 8}
    imgs, labels = synthetic_mnist(60 * clients, seed=0)
    parts = partition_dirichlet(imgs, labels, clients, alpha=0.5, seed=0)
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
        worst, moved, reach = compare_states(label, ta, tb, start)
        print(f"small input, {label}: losses within 1e-4 rel, params max "
              f"abs diff {worst:.3e}; the BN-fed biases moved at most "
              f"{moved:.4f} lr (Adam's reach {reach:.4f} lr)")

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


@fp32_convs
def phase_small_split_reference(dev):
    """On the card at a small width (base_filters 8, batch 8, a plan of 3
    boundaries, the fused int8+dp stage through the kernel): the pipelined
    step at K = 1 against ``run``, bit for bit; at K = 2 with the identity stage against the mean
    of the per-chunk monolithic gradients; the batched per-example staged
    step against the loop oracle with the same noise; and two DP-SGD
    trainers through the split: identity stage against no split, K = 4
    against K = 1.  The bit-for-bit checks run with cuDNN's deterministic
    algorithms, which make two runs of one computation equal."""
    import functools
    from repro_torch import keys
    from repro_torch.config import DCGANConfig, SplitConfig
    from repro_torch.core import split as ts
    from repro_torch.core.devices import Client, Device
    from repro_torch.core.gan import bce_logits, d_loss_fn
    from repro_torch.core.selection import make_plan
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.models.dcgan import (disc_apply_layer, disc_init,
                                          disc_layer_costs, disc_layer_names)
    from repro_torch.tree import leaves, tree_map, value_and_grad

    c = DCGANConfig(base_filters=8)
    costs = disc_layer_costs(c)
    plan = make_plan(Client("c0", [Device("d0", 1.0, 2),
                                   Device("d1", 2.0, 2)]),
                     [(n, costs[n]) for n in disc_layer_names(c)],
                     "sorted_single", 3)
    tails = (functools.partial(bce_logits, target=1.0),
             functools.partial(bce_logits, target=0.0))

    def execution(name, k=1):
        stage = ts.make_boundary_stage(SplitConfig(
            enabled=True, stage_clip=1.0, stage_sigma=0.5, use_kernel=True),
            name)
        return ts.SplitExecution(plan, functools.partial(disc_apply_layer,
                                                         c=c), tails,
                                 stage=stage, pipeline_microbatches=k)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))

    def worst(got, want):
        """Largest difference of a leaf over that leaf's largest magnitude
        (BN-fed biases: over the whole tree's largest)."""
        top = max(float(w.abs().max()) for w in leaves(want))
        return max(float((g - w).abs().max()) / (
            top if p[-2:] in BN_FED_BIASES else float(w.abs().max()))
            for p, g, w in zip(paths(got), leaves(got), leaves(want)))

    params = disc_init(torch.Generator().manual_seed(0), c, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    real = torch.rand((8, 28, 28, 1), generator=gen, device=dev) * 2 - 1
    fake = torch.tanh(torch.randn((8, 28, 28, 1), generator=gen,
                                  device=dev))
    key = keys.root(keys.STAGE, 5)
    check(execution("int8+dp").num_boundaries == 3, "the plan is not 3 "
          "boundaries")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ex = execution("int8+dp", k=4)
        l1, g1, _ = ex.run(params, (real, fake), key)
        lp, gp, _ = ex.run_pipelined(params, (real, fake), key,
                                     num_microbatches=1)
        check(torch.equal(l1, lp) and equal(g1, gp),
              "run_pipelined at K = 1 differs from run")
        print("small input, pipelined split (int8+dp, kernel): K = 1 equals "
              "run, bit for bit")

        pl, pg = execution("identity", 2).value_and_grad(params, real, fake)
        vg = value_and_grad(functools.partial(d_loss_fn, c=c))
        (l0, g0), (l1, g1) = (vg(params, real[m * 4:(m + 1) * 4],
                                 fake[m * 4:(m + 1) * 4]) for m in (0, 1))
        ml, mg = (l0 + l1) * 0.5, tree_map(lambda a, b: (a + b) * 0.5, g0,
                                           g1)
        diff = worst(pg, mg)
        check(abs(float(pl - ml)) <= 1e-6 * abs(float(ml)) and diff <= 1e-6,
              f"K = 2 identity: loss {float(pl)} vs {float(ml)}, grads "
              f"{diff}")
        print(f"small input, pipelined identity split at K = 2 vs the mean "
              f"of the 2 chunks' monolithic gradients: loss diff "
              f"{abs(float(pl - ml)):.3e}, grads max diff {diff:.3e} of each "
              f"leaf's largest (tolerance 1e-6)")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # the batched per-example step against the loop oracle, same noise.
    # Through int8 a quantum can flip between the two (the batched
    # convolutions sum in another order) and is not diluted by a batch
    # mean: the classifier's weight gradient is its input times one
    # number, so one flipped input element moves it by up to 1/127 of the
    # leaf's largest.  Losses at 1e-3 relative, gradients at 1/127.
    ex = execution("int8+dp")
    before = boundary_fuse_kernel.launches
    bl, bg = ex.per_example_value_and_grad(params, real, fake, key)
    batched = boundary_fuse_kernel.launches - before
    ol, og = ex.per_example_oracle(params, real, fake, key)
    check(batched == 12, f"the batched per-example step launched "
          f"boundary_fuse {batched} times, expected 12 (one a crossing)")
    ldiff = float(((bl - ol).abs() / ol.abs()).max())
    diff = worst(bg, og)
    check(ldiff <= 1e-3 and diff <= 1 / 127,
          f"per-example step vs oracle: losses {ldiff}, grads {diff}")
    print(f"small input, batched per-example staged step (int8+dp, kernel, "
          f"12 launches) vs the loop oracle (96 launches): losses max rel "
          f"diff {ldiff:.3e} (tolerance 1e-3), grads max diff {diff:.3e} of "
          f"each leaf's largest (tolerance 1/127)")

    # DP-SGD through the split, trainers: with the identity stage against
    # DP-SGD without the split (noise on; the same dp_clip draw), losses
    # within 1e-4 and parameters as compare_states holds them; and at
    # K = 4 against K = 1, bit for bit but the virtual round time
    dp = {**DP_SGD, "privacy.clip_norm": 0.1}
    ta, tb = small_trainer({**dp, "split.enabled": True}), small_trainer(dp)
    start = [t.clone() for t in leaves(ta.state.g_params)
             + leaves(ta.state.d_params["c0"])]
    for _ in range(ROUNDS):
        ma = ta.train_epoch(batches_per_client=BATCHES)
        mb = tb.train_epoch(batches_per_client=BATCHES)
        for k in ("d_loss", "g_loss"):
            check(abs(ma[k] - mb[k]) <= 1e-4 * abs(mb[k]),
                  f"dp-sgd identity split vs unsplit: {k} {ma[k]} vs "
                  f"{mb[k]}")
    diff, moved, reach = compare_states("dp-sgd identity split vs unsplit",
                                        ta, tb, start)
    print(f"small input, dp-sgd round through the identity-stage split vs "
          f"without the split (noise on): losses within 1e-4 rel, params "
          f"max abs diff {diff:.3e}; the BN-fed biases moved at most "
          f"{moved:.4f} lr (Adam's reach {reach:.4f} lr)")
    torch.backends.cudnn.deterministic = True
    try:
        over = {**DP_SGD, **SPLIT}
        t1 = small_trainer(over)
        t4 = small_trainer({**over, "split.pipeline_microbatches": 4})
        times = ("round_time_s", "clock_s")
        for _ in range(ROUNDS):
            m1 = t1.train_epoch(batches_per_client=BATCHES)
            m4 = t4.train_epoch(batches_per_client=BATCHES)
            check({k: v for k, v in m1.items() if k not in times}
                  == {k: v for k, v in m4.items() if k not in times},
                  f"dp-sgd split K = 4 vs K = 1: {m4} vs {m1}")
        check(equal(t1.state.g_params, t4.state.g_params) and all(
            equal(t1.state.d_params[c_], t4.state.d_params[c_])
            for c_ in t1.state.d_params), "dp-sgd split K = 4 parameters "
              "differ from K = 1")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print("small input, dp-sgd split (int8+dp, both kernels, noise on) at "
          "K = 4 vs K = 1: every metric but the virtual round time and "
          "every parameter equal, bit for bit")


def phase_small_vectorized_reference(dev):
    """On the card at a small width, 3 clients (split signature groups of
    2 and 1), kernels on: the vectorized round against the loop round for
    plain, DP-SGD (noise on) and the int8+dp split, at the reference's
    tolerances (d_loss 1e-5, each client's D 5e-5, the dead biases
    skipped); then, with cuDNN's deterministic algorithms (two runs of one
    computation equal): ``fed.shard_clients`` on one card (no mesh, 1
    shard) against the unsharded vectorized round, and rounds with cuDNN's
    TF32 flag on globally against the same rounds with it off, bit for
    bit, the flag reading as set afterwards."""
    from repro_torch.models.dcgan import disc_apply
    from repro_torch.tree import leaves

    def close(a, b, tol):
        return abs(a - b) <= tol + tol * abs(b)

    for label, over in (("plain", {}), ("dp-sgd", DP_SGD),
                        ("split int8+dp", SPLIT)):
        base = {"fed.kernel_aggregation": True, **over}
        ta = small_trainer(base, clients=3)
        tb = small_trainer({**base, "fed.backend": "vectorized"}, clients=3)
        for _ in range(ROUNDS):
            ma = ta.train_epoch(batches_per_client=BATCHES)
            mb = tb.train_epoch(batches_per_client=BATCHES)
            check(close(mb["d_loss"], ma["d_loss"], VEC_LOSS_TOL),
                  f"vectorized {label}: d_loss {mb['d_loss']} vs loop "
                  f"{ma['d_loss']}")
        worst = 0.0
        for cid in ta.state.d_params:
            da, db = ta.state.d_params[cid], tb.state.d_params[cid]
            for p, a, b in zip(paths(da), leaves(da), leaves(db)):
                if p not in DEAD_BIASES:
                    excess = float(((b - a).abs()
                                    - VEC_PARAM_TOL * a.abs()).max())
                    worst = max(worst, excess)
                    check(excess <= VEC_PARAM_TOL, f"vectorized {label}: "
                          f"{cid} {p} beyond 5e-5 by {excess}")
        print(f"small input, vectorized {label} round vs loop (3 clients): "
              f"d_loss within 1e-5, D within 5e-5 (largest excess over "
              f"the relative part {worst:.3e})")

    def state(tr):
        return leaves(tr.state.g_params) + [
            l for c in sorted(tr.state.d_params)
            for l in leaves(tr.state.d_params[c])]

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.deterministic = True
    try:
        vec = {"fed.backend": "vectorized", "fed.kernel_aggregation": True}
        ta = small_trainer(vec, clients=3)
        tb = small_trainer({**vec, "fed.shard_clients": True}, clients=3)
        check(tb._client_mesh() is None and tb._num_shards("vectorized")
              == 1, "shard_clients on one card built a mesh")
        for _ in range(ROUNDS):
            ta.train_epoch(batches_per_client=BATCHES)
            tb.train_epoch(batches_per_client=BATCHES)
        check(all(torch.equal(a, b) for a, b in zip(state(ta), state(tb))),
              "shard_clients on one card differs from the unsharded round")
        print("small input, fed.shard_clients on one card: no mesh, 1 "
              "shard, every leaf equal to the unsharded vectorized round")

        # the flag matters on this card: one discriminator forward with
        # TF32 on against off, outside the trainer's guard
        tr = small_trainer({}, clients=3)
        x = tr._sample_real("c0", 64)
        outs = []
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            outs.append(disc_apply(tr.state.d_params["c0"], x, tr.c))
        tf32_diff = float((outs[0] - outs[1]).abs().max())
        for backend in ("loop", "vectorized"):
            runs = []
            for flag in (True, False):
                torch.backends.cudnn.allow_tf32 = flag
                t = small_trainer({"fed.backend": backend,
                                   "fed.kernel_aggregation": True},
                                  clients=3)
                for _ in range(ROUNDS):
                    t.train_epoch(batches_per_client=BATCHES)
                t.generate(4)
                check(torch.backends.cudnn.allow_tf32 is flag,
                      f"the trainer left cudnn.allow_tf32 "
                      f"{torch.backends.cudnn.allow_tf32}, was {flag}")
                runs.append(state(t))
            check(all(torch.equal(a, b) for a, b in zip(*runs)),
                  f"{backend}: the round with TF32 on globally differs "
                  f"from the round with it off")
        print(f"small input, cuDNN TF32 on globally (PyTorch's default) vs "
              f"off: loop and vectorized rounds equal in every leaf, the "
              f"flag as set afterwards; the same discriminator forward "
              f"outside the guard differs by {tf32_diff:.3e}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


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
LM_FWD = (2, 2048)              # and on the other decoders
SERVE_REQUESTS, SERVE_TOKENS = 4, 16
# |loss through the kernel - through the plain path| at full depth: the
# two sum in different orders, and every layer's bf16 compute carries that
# into the loss.  rwkv6-1.6b measured on an H100 80GB HBM3 at 700 W
# (PERF.md §6): 9.6e-04 for the wkv6 kernel, 2.1e-03 for the design it
# replaced; the limit holds both with room, and holds the flash paths of
# recurrentgemma-9b (D = 256, window) and granite-20b (48 heads on 1).
PLAIN_LOSS_TOL = 4e-3
# the LM paths at full width: arch -> the config's widths (checked before
# any depth cut), the forward's batch x sequence, the layers run where one
# card cannot hold them all (with why), the serve prompts' token range,
# and whether the forward also runs on the plain path
LM_PATHS = {
    "qwen3-14b": dict(
        widths=dict(num_layers=40, d_model=5120, num_heads=40,
                    num_kv_heads=8, head_dim=128, d_ff=17408,
                    vocab_size=151936), fwd=QWEN_FWD),
    "rwkv6-1.6b": dict(
        widths=dict(num_layers=24, d_model=2048, num_heads=32, head_dim=64,
                    d_ff=7168, vocab_size=65536), fwd=RWKV_FWD, plain=True),
    "olmoe-1b-7b": dict(
        widths={"num_layers": 16, "d_model": 2048, "num_heads": 16,
                "num_kv_heads": 16, "head_dim": 128, "vocab_size": 50304,
                "moe.num_experts": 64, "moe.top_k": 8,
                "moe.d_ff_expert": 1024}),
    "deepseek-v2-lite-16b": dict(
        widths={"num_layers": 27, "d_model": 2048, "num_heads": 16,
                "head_dim": 128, "vocab_size": 102400,
                "moe.num_experts": 64, "moe.num_shared_experts": 2,
                "moe.top_k": 6, "moe.d_ff_expert": 1408,
                "mla.kv_lora_rank": 512, "mla.rope_head_dim": 64,
                "mla.v_head_dim": 128}),
    "recurrentgemma-9b": dict(
        widths={"num_layers": 38, "d_model": 4096, "num_heads": 16,
                "num_kv_heads": 1, "head_dim": 256, "d_ff": 12288,
                "vocab_size": 256000, "sliding_window": 2048,
                "rglru.lru_width": 4096, "rglru.conv_width": 4},
        plain=True),
    # the decoder's 448 positions bound its sequence and its prompts
    "whisper-base": dict(
        widths={"num_layers": 6, "d_model": 512, "num_heads": 8,
                "head_dim": 64, "d_ff": 2048, "vocab_size": 51865,
                "encdec.encoder_layers": 6, "encdec.encoder_seq": 1500,
                "encdec.max_target_positions": 448},
        fwd=(2, 448), prompts=(32, 401)),
    "chameleon-34b": dict(
        widths=dict(num_layers=48, d_model=8192, num_heads=64,
                    num_kv_heads=8, head_dim=128, d_ff=22016,
                    vocab_size=65536)),
    "granite-20b": dict(
        widths=dict(num_layers=52, d_model=6144, num_heads=48,
                    num_kv_heads=1, head_dim=128, d_ff=24576,
                    vocab_size=49152), plain=True),
    "qwen2-72b": dict(
        widths=dict(num_layers=80, d_model=8192, num_heads=64,
                    num_kv_heads=8, head_dim=128, d_ff=29568,
                    vocab_size=152064),
        layers=32, cut="80 layers are 145.4 GB of bf16 parameters; 32 are "
        "~61 GB, which leave room on one 80 GB card for the forward"),
    "llama3-405b": dict(
        widths=dict(num_layers=126, d_model=16384, num_heads=128,
                    num_kv_heads=8, head_dim=128, d_ff=53248,
                    vocab_size=128256),
        layers=8, cut="126 layers are 811.7 GB of bf16 parameters; 8 are "
        "~59 GB, which leave room on one 80 GB card for the forward and "
        "its fp32 head (8.4 GB)"),
}
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
    b, s = LM_FWD
    # the LM paths' other attention layers: recurrentgemma-9b (16 heads on
    # 1 kv head of 256, window 2048), granite-20b (48 on 1), llama3-405b
    # (128 on 8); qwen2-72b's and chameleon-34b's 64/8 and olmoe-1b-7b's
    # 16/16 lie between these and qwen3-14b's 40/8
    lm_shapes = {"16/1 D 256 window 2048": ((b, s, s, 16, 1, 256), 2048),
                 "48/1": ((b, s, s, 48, 1, 128), 0),
                 "128/8": ((b, s, s, 128, 8, 128), 0)}
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        cases += [(label, shape, dict(causal=True, window=window), dt)
                  for label, (shape, window) in lm_shapes.items()]
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
    lm_err = {}
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
        e = float((got.float() - want.float()).abs().max())
        err[dt] = max(err[dt], e)
        if label in lm_shapes:
            lm_err[(label, dt)] = e
        del q, k, v, got, want
    for (label, dt), e in lm_err.items():
        print(f"flash_attention vs plain at {label} "
              f"{lm_shapes[label][0]} {dt}: max abs err {e:.3e} (tolerance "
              f"{FLASH_TOL[dt]})")
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
            ("fp32 D 256 causal", torch.float32, 0, d256_shape),
            *((f"bf16 {label}", torch.bfloat16, window, shape)
              for label, (shape, window) in lm_shapes.items())):
        q, k, v = qkv(*shape, dt)
        variants = {
            "kernel": lambda: flash_attention_kernel(q, k, v, causal=True,
                                                     window=window),
            "plain": lambda: attention_ref(q, k, v, causal=True,
                                           window=window)}
        if not window or window >= shape[2]:
            # a window of at least Sk masks nothing more than causality
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


def lm_forward_batch(dev, m, b, s):
    """The forward's batch: synthetic tokens and next-token labels; for
    the VLM the tokens come from ``vlm_interleave`` (one 256-token image
    span a sequence), for whisper the batch also carries the stub
    frontend's frame embeddings."""
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models.frontends import (audio_frame_embeddings,
                                              vlm_interleave)
    gen = torch.Generator(device=dev).manual_seed(0)
    if m.family == "vlm":
        toks, mask = vlm_interleave(gen, b, s + 1, m)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        print(f"{m.name}: tokens from vlm_interleave, "
              f"{int(mask[:, :-1].sum())} of {b * s} image tokens")
    else:
        batch = {k: torch.as_tensor(a, device=dev) for k, a in
                 synthetic_lm_batch(b, s, m.vocab_size, seed=0).items()}
    if m.encdec.enabled:
        batch["enc_embeds"] = audio_frame_embeddings(gen, b, m)
    return batch


def check_full_width(arch, cfg):
    """``cfg``'s model has the widths ``LM_PATHS[arch]`` names (checked
    before any depth cut)."""
    want = LM_PATHS[arch]["widths"]
    got = {}
    for name in want:
        v = cfg.model
        for part in name.split("."):
            v = getattr(v, part)
        got[name] = v
    check(got == want, f"{arch} is not at full width: {got}")


def drive_lm(dev, arch, path):
    """One LM at full width (``path``: its entry of ``LM_PATHS``):
    ``lm_loss`` forward under ``torch.no_grad`` with
    ``parallel.use_flash_kernel`` on a synthetic batch, then
    ``serve_batch`` (4 requests of the path's prompt lengths, 16 greedy
    tokens, bf16 cache).  Every kernel's launch count is set to 0 just
    before each of the two and read just after: the forward must launch
    flash_attention once an ``attn`` / ``moe`` layer and wkv6 once an
    ``rwkv`` layer at the depth run and nothing else, serving nothing at
    all.  With ``path["plain"]``, the forward also runs once on the plain
    path, and the two losses must agree within ``PLAIN_LOSS_TOL``.
    Returns the forward's launches of each kernel."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.launch.serve import Request, serve_batch
    from repro_torch.models.blocks import layer_kinds
    from repro_torch.models.transformer import lm_init, lm_loss
    from repro_torch.runtime.serve import _dtype
    from repro_torch.tree import leaves

    cfg = get_config(arch).override({"parallel.use_flash_kernel": True})
    check_full_width(arch, cfg)
    full_depth = cfg.model.num_layers
    if path.get("layers"):
        cfg = cfg.override({"model.num_layers": path["layers"]})
    m = cfg.model
    kinds = layer_kinds(m)
    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm_init(0, m, _dtype(cfg.parallel.param_dtype), dev)
    torch.cuda.synchronize()
    pbytes = sum(l.numel() * l.element_size() for l in leaves(params))
    depth = (f"{m.num_layers} of {full_depth} layers (cut: {path['cut']})"
             if path.get("layers") else f"{m.num_layers} layers (full depth)")
    print(f"{arch}: {depth}, kinds "
          f"{ {k: kinds.count(k) for k in sorted(set(kinds))} }, d_model "
          f"{m.d_model}, {len(leaves(params))} leaves, {pbytes / 1e9:.3f} "
          f"GB of {cfg.parallel.param_dtype} parameters, init "
          f"{time.perf_counter() - t0:.2f} s")
    b, s = path.get("fwd", LM_FWD)
    batch = lm_forward_batch(dev, m, b, s)
    cd = _dtype(cfg.parallel.compute_dtype)

    def forward(use_kernel=cfg.parallel.use_flash_kernel):
        with torch.no_grad():
            return lm_loss(params, batch, m, cd, cfg.parallel.remat,
                           use_kernel=use_kernel)

    want = {k: 0 for k in wrappers}
    want["flash_attention"] = sum(k in ("attn", "moe") for k in kinds)
    want["wkv6"] = kinds.count("rwkv")
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    loss, met = forward()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    check(counts == want, f"{arch} forward: launches {counts}, expected "
          f"{want}")
    check(math.isfinite(float(loss)) and float(met["tokens"]) == b * s
          and math.isfinite(float(met["aux_loss"])),
          f"{arch} forward: loss {float(loss)}, aux {met['aux_loss']}, "
          f"tokens {met['tokens']}")
    t0 = time.perf_counter()
    loss2, _ = forward()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check(torch.equal(loss, loss2), f"{arch}: two forwards differ")
    launched = {k: n for k, n in counts.items() if n}
    print(f"{arch} lm_loss forward, B {b} x S {s}, use_flash_kernel: loss "
          f"{float(loss):.6f} (ln vocab {math.log(m.vocab_size):.3f}, aux "
          f"{float(met['aux_loss']):.6f}), wall {cold:.3f} s cold, "
          f"{warm:.3f} s warm, the two equal bit for bit; launches "
          f"{launched or 'none'} as expected; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    if path.get("plain"):
        t0 = time.perf_counter()
        plain, _ = forward(use_kernel=False)
        torch.cuda.synchronize()
        gap = abs(float(loss) - float(plain))
        check(gap <= PLAIN_LOSS_TOL, f"{arch} forward: loss through the "
              f"kernel {float(loss)}, plain {float(plain)}: {gap} > "
              f"{PLAIN_LOSS_TOL}")
        print(f"{arch} lm_loss forward on the plain path: loss "
              f"{float(plain):.6f}, wall {time.perf_counter() - t0:.3f} s; "
              f"|kernel - plain| {gap:.3e} (limit {PLAIN_LOSS_TOL})")
        del plain
    del batch, loss, loss2, met

    scfg = get_config(arch, "decode_32k").override(
        {"model.num_layers": m.num_layers})
    check(scfg.parallel.cache_dtype == "bfloat16", "cache is not bf16")
    rng = np.random.default_rng(0)
    lo, hi = path.get("prompts", (128, 1025))
    lens = [int(n) for n in rng.integers(lo, hi, SERVE_REQUESTS)]
    reqs = [Request(i, synthetic_tokens(1, n, m.vocab_size, seed=i)[0])
            for i, n in enumerate(lens)]
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    serve_batch(scfg, reqs, SERVE_TOKENS, device=dev, params=params,
                verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    check(not any(counts.values()), f"{arch} serve: launches {counts}")
    for r in reqs:
        check(len(r.generated) == SERVE_TOKENS and all(
            0 <= t < m.vocab_size for t in r.generated),
              f"{arch} serve: request {r.rid} generated {r.generated}")
    print(f"{arch} serve_batch: prompts {lens}, {SERVE_TOKENS} tokens each, "
          f"wall {wall:.3f} s, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, no kernel "
          f"launched (prefill and decode take the plain attention / scan, "
          f"as in the reference)")
    del params
    torch.cuda.empty_cache()
    return {k: n for k, n in want.items() if n}


def phase_lm_paths(dev):
    """Every LM of ``LM_PATHS`` through ``drive_lm``.  Returns (each
    kernel's forward launches over all of them, and by forward)."""
    launches, by_path = {}, {}
    for arch, path in LM_PATHS.items():
        t0 = time.perf_counter()
        for name, n in drive_lm(dev, arch, path).items():
            launches[name] = launches.get(name, 0) + n
            by_path.setdefault(name, {})[f"{arch} forward"] = n
        print(f"{arch}: {time.perf_counter() - t0:.1f} s")
    return launches, by_path


def phase_lm_small_reference(dev):
    """On the card at smoke width, fp32, TF32 off, for every arch of
    ``LM_PATHS`` (recurrentgemma-9b at 4 layers, so one attention layer
    runs): ``lm_apply`` through the kernels against the plain path
    (1e-4), and prefill + decode against the teacher-forced forward (5e-4,
    the reference's pin), also on a sliding-window ring (qwen3-14b,
    recurrentgemma-9b); and a whisper decode past its cache (max target
    positions cut to 8, decoding to 16) against the same run on the CPU
    (1e-4)."""
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import (lm_apply, lm_decode_step,
                                                lm_init, lm_prefill)
    from repro_torch.tree import tree_map

    def setup(arch, seq, over=None, device=dev):
        cfg = reduce_for_smoke(get_config(arch, "train_4k"), seq_len=seq,
                               batch=2)
        if arch == "recurrentgemma-9b":
            cfg = cfg.override({"model.num_layers": 4})
        if over:
            cfg = cfg.override(over)
        m = cfg.model
        params = lm_init(0, m, torch.float32, device)
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, m.vocab_size, (2, seq)), device=device)}
        if m.encdec.enabled:
            batch["enc_embeds"] = torch.as_tensor(0.1 * rng.standard_normal(
                (2, m.encdec.encoder_seq, m.d_model)), dtype=torch.float32,
                device=device)
        return m, params, batch

    def decode_run(m, params, batch, pre, seq):
        extra = {k: v for k, v in batch.items() if k == "enc_embeds"}
        toks = batch["tokens"]
        lg, state, idx = lm_prefill(params, dict(extra, tokens=toks[:, :pre]),
                                    m, cache_len=seq,
                                    cache_dtype=torch.float32)
        out = [lg]
        for t in range(pre, seq):
            lg, state = lm_decode_step(params, toks[:, t], state, t, m)
            out.append(lg)
        return out

    ring = {"model.attention": "sliding", "model.sliding_window": 5}
    with torch.no_grad():
        for arch in LM_PATHS:
            m, params, batch = setup(arch, 100)
            a, _ = lm_apply(params, batch, m, use_kernel=False)
            b, _ = lm_apply(params, batch, m, use_kernel=True)
            d = float((a - b).abs().max())
            check(d <= 1e-4, f"{arch} small: kernel path vs plain {d}")
            print(f"small input, {arch} lm_apply (2 x 100), kernel path vs "
                  f"plain path: max abs diff {d:.3e} (pin 1e-4)")
        cases = [(arch, 12, 8, None) for arch in LM_PATHS] + [
            ("qwen3-14b", 24, 6, ring),
            ("recurrentgemma-9b", 24, 6, dict(ring, **{
                "model.num_layers": 3}))]
        for arch, seq, pre, over in cases:
            m, params, batch = setup(arch, seq, over)
            full, _ = lm_apply(params, batch, m)
            got = decode_run(m, params, batch, pre, seq)
            errs = [float((g - full[:, pre - 1 + i]).abs().max())
                    for i, g in enumerate(got)]
            check(max(errs) < 5e-4, f"{arch} {over}: decode drift {errs}")
            print(f"small input, {arch}{' ring' if over else ''}: prefill "
                  f"{pre} + decode to {seq} vs forward, max abs diff "
                  f"{max(errs):.3e} (pin 5e-4)")
        past = {"model.encdec.max_target_positions": 8}
        m, params, batch = setup("whisper-base", 16, past)
        got = decode_run(m, params, batch, 6, 16)
        cpu = torch.device("cpu")
        want = decode_run(m, tree_map(lambda t: t.to(cpu), params),
                          tree_map(lambda t: t.to(cpu), batch), 6, 16)
        d = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        check(d <= 1e-4, f"whisper decode past its cache: card vs CPU {d}")
        print(f"small input, whisper-base with 8 target positions: prefill "
              f"6 + decode to 16 (past the cache and the position table; "
              f"both clamp), card vs CPU max abs diff {d:.3e} (pin 1e-4)")


# ---------------------------------------------------------------------------
# LM training at full width: the train launcher, the train step, the FSL step
# ---------------------------------------------------------------------------

# train_loop on rwkv6-1.6b (the reference launcher's own arch), full depth
TRAIN_RWKV = dict(batch=4, seq=1024, steps=2)
# make_train_step on qwen3-14b at full width, 4 of its 40 layers (40 are
# 29.5 GB of bf16 parameters and 59 GB of bf16 AdamW state: past one card
# with the step's gradients); steps taken at the schedule's indices from
# the end of its warmup, where bf16 parameters move by more than an ulp
TRAIN_QWEN = dict(layers=4, batch=8, seq=2048, steps=2)
# make_fsl_train_step on whisper-base at full size
TRAIN_WHISPER = dict(clients=3, batch=8, seq=448, local_steps=2, steps=4)
TRAIN_PEAK_GB = 76
# the small reference's card-vs-CPU pin, of each leaf's largest value
# (rwkv6's fp32 gradient is ill-conditioned at smoke size: the JAX
# package's own is 2.7e-5 of a leaf's largest from a float64 evaluation;
# tests/test_torch_train.py)
TRAIN_SMALL_TOL = {"qwen3-14b": 1e-5, "whisper-base": 1e-5,
                   "rwkv6-1.6b": 1e-4}


def tree_digest(tree):
    """Per leaf, its float64 sum and sum of squares (on the leaf's device):
    any moved element changes them far beyond their rounding."""
    from repro_torch.tree import leaves
    return [torch.stack([l.double().sum(), l.double().square().sum()])
            for l in leaves(tree)]


def moved_leaves(before, after):
    return sum(not torch.equal(a, b) for a, b in zip(before, after))


def check_finite_tree(label, tree):
    from repro_torch.tree import leaves
    for leaf in leaves(tree):
        check(leaf.device.type == "cuda", f"{label}: a leaf on {leaf.device}")
        check(bool(torch.isfinite(leaf.float()).all()),
              f"{label}: non-finite parameter")


def report_train(label, tokens, walls, losses, peak, counts):
    warm = walls[-1]
    print(f"{label}: losses {[round(x, 6) for x in losses]}, step walls "
          f"{[round(w, 3) for w in walls]} s (cold first), warm step "
          f"{warm:.3f} s = {tokens / warm:.0f} tokens/s, peak memory "
          f"{peak / 1e9:.2f} GB, hand-written kernel launches "
          f"{counts or 'none'}")


def phase_train_paths(dev):
    """LM training at full width, every kernel's launch count set to 0
    just before each path and read just after (training runs none: the
    kernels are forward-only, as in the reference):
    (a) ``launch.train.train_loop`` on rwkv6-1.6b, 24 layers, fp32
    parameters and AdamW state, bf16 compute, B 4 x T 1024, 2 steps;
    (b) ``make_train_step`` on qwen3-14b, 4 of 40 layers, bf16 parameters
    and AdamW state, 8 micro-batches of B 8 x S 2048, 2 steps;
    (c) ``make_fsl_train_step`` on whisper-base (6 + 6 layers), 3 clients
    x B 8 x 448 target tokens, FedAvg every 2 steps, 4 steps: the
    replicas differ after steps 0 and 2 and are equal bit for bit after
    steps 1 and 3.
    Each prints its warm step's wall, tokens a second, peak memory and
    losses; every loss and parameter is finite and the warm step moves
    the parameters.  Then a step built with ``use_flash_kernel`` is
    refused and launches nothing."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.launch.train import train_loop
    from repro_torch.models.frontends import audio_frame_embeddings
    from repro_torch.models.transformer import lm_init
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import make_fsl_train_step, make_train_step
    from repro_torch.runtime.serve import _dtype
    from repro_torch.tree import leaves, tree_map

    wrappers = kernel_wrappers()

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts(label):
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        check(not counts, f"{label}: kernel launches {counts}, expected none")
        return counts

    # (a) the launcher on rwkv6-1.6b
    t0 = time.perf_counter()
    a = TRAIN_RWKV
    cfg = get_config("rwkv6-1.6b", "train_4k").override(
        {"shape.global_batch": a["batch"], "shape.seq_len": a["seq"]})
    check_full_width("rwkv6-1.6b", cfg)
    check(cfg.parallel.param_dtype == "float32"
          and cfg.parallel.compute_dtype == "bfloat16"
          and cfg.optim.name == "adamw" and not cfg.optim.state_dtype
          and cfg.parallel.remat == "full", f"rwkv6 train config {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, digests = [], []

    def on_step(i, params, metrics, seconds):
        walls.append(seconds)
        digests.append(tree_digest(params))

    zero_counts()
    params, losses = train_loop(cfg, a["steps"], device=dev, on_step=on_step,
                                log_every=a["steps"])
    torch.cuda.synchronize()
    counts = read_counts("rwkv6-1.6b train_loop")
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses),
          f"rwkv6-1.6b train_loop: losses {losses}")
    check_finite_tree("rwkv6-1.6b train_loop", params)
    moved = moved_leaves(digests[-2], digests[-1])
    check(moved > 0, "rwkv6-1.6b train_loop: the warm step moved nothing")
    n_params = sum(l.numel() for l in leaves(params))
    print(f"rwkv6-1.6b train_loop: {cfg.model.num_layers} layers (full "
          f"depth), {n_params / 1e9:.3f} B fp32 parameters, AdamW fp32 "
          f"state, bf16 compute, remat {cfg.parallel.remat}, B {a['batch']} "
          f"x T {a['seq']}; the warm step moved {moved} of "
          f"{len(digests[-1])} leaves")
    report_train("rwkv6-1.6b train_loop", a["batch"] * a["seq"], walls,
                 losses, peak, counts)
    check(peak / 1e9 <= TRAIN_PEAK_GB, f"rwkv6-1.6b peak {peak / 1e9} GB")
    del params, digests
    print(f"rwkv6-1.6b train path: {time.perf_counter() - t0:.1f} s")

    # (b) the train step on qwen3-14b
    t0 = time.perf_counter()
    b = TRAIN_QWEN
    cfg = get_config("qwen3-14b", "train_4k")
    check_full_width("qwen3-14b", cfg)
    cfg = cfg.override({"model.num_layers": b["layers"],
                        "shape.global_batch": b["batch"],
                        "shape.seq_len": b["seq"]})
    m = cfg.model
    check(cfg.parallel.param_dtype == "bfloat16"
          and cfg.parallel.microbatches == 8 and not cfg.optim.state_dtype,
          f"qwen3-14b train config {cfg.parallel}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm_init(0, m, torch.bfloat16, dev)
    opt_state = make_optimizer(cfg.optim).init(params)
    step = make_train_step(cfg)
    walls, losses, digests = [], [], [tree_digest(params)]
    zero_counts()
    for i in range(b["steps"]):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 synthetic_lm_batch(b["batch"], b["seq"], m.vocab_size,
                                    seed=i).items()}
        torch.cuda.synchronize()
        ts = time.perf_counter()
        params, opt_state, met = step(params, opt_state, batch,
                                      cfg.optim.warmup_steps + i)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - ts)
        digests.append(tree_digest(params))
    counts = read_counts("qwen3-14b train step")
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses),
          f"qwen3-14b train step: losses {losses}")
    check_finite_tree("qwen3-14b train step", params)
    check_finite_tree("qwen3-14b AdamW state", opt_state)
    moved = moved_leaves(digests[-2], digests[-1])
    check(moved > 0, "qwen3-14b train step: the warm step moved nothing")
    n_params = sum(l.numel() for l in leaves(params))
    print(f"qwen3-14b make_train_step: {m.num_layers} of 40 layers (cut: "
          f"40 are 29.5 GB of bf16 parameters and as much again twice in "
          f"AdamW state), {n_params / 1e9:.3f} B bf16 parameters, bf16 "
          f"AdamW state, {cfg.parallel.microbatches} micro-batches of "
          f"B {b['batch'] // cfg.parallel.microbatches} x S {b['seq']}, "
          f"steps at schedule indices {cfg.optim.warmup_steps}-"
          f"{cfg.optim.warmup_steps + b['steps'] - 1} (lr "
          f"{float(met['lr']):.3g}); the warm step moved {moved} of "
          f"{len(digests[-1])} leaves")
    report_train("qwen3-14b make_train_step", b["batch"] * b["seq"], walls,
                 losses, peak, counts)
    check(peak / 1e9 <= TRAIN_PEAK_GB, f"qwen3-14b peak {peak / 1e9} GB")
    del params, opt_state, digests, batch
    print(f"qwen3-14b train path: {time.perf_counter() - t0:.1f} s")

    # (c) the FSL step on whisper-base
    t0 = time.perf_counter()
    c = TRAIN_WHISPER
    n = c["clients"]
    cfg = get_config("whisper-base", "train_4k")
    check_full_width("whisper-base", cfg)
    cfg = cfg.override({"fsl.local_steps": c["local_steps"],
                        "shape.global_batch": c["batch"],
                        "shape.seq_len": c["seq"]})
    m = cfg.model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm_init(0, m, _dtype(cfg.parallel.param_dtype), dev)
    opt_state = make_optimizer(cfg.optim).init(params)
    cp = tree_map(lambda x: x[None].expand(n, *x.shape), params)
    co = tree_map(lambda x: x[None].expand(n, *x.shape), opt_state)
    step = make_fsl_train_step(cfg, n)
    gen = torch.Generator(device=dev).manual_seed(0)
    walls, losses, spreads = [], [], []
    prev = tree_digest(cp)
    zero_counts()
    for i in range(c["steps"]):
        batch = {k: torch.as_tensor(v, device=dev).reshape(n, c["batch"], -1)
                 for k, v in synthetic_lm_batch(n * c["batch"], c["seq"],
                                                m.vocab_size,
                                                seed=i).items()}
        batch["enc_embeds"] = audio_frame_embeddings(
            gen, n * c["batch"], m, _dtype(cfg.parallel.compute_dtype)
        ).reshape(n, c["batch"], m.encdec.encoder_seq, m.d_model)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        cp, co, met = step(cp, co, batch, i)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - ts)
        equal = all(torch.equal(l[0], l[r]) for l in leaves(cp)
                    for r in range(1, n))
        averaged = (i + 1) % c["local_steps"] == 0
        check(equal == averaged, f"whisper-base FSL step {i}: replicas "
              f"equal {equal}, a FedAvg step {averaged}")
        spreads.append(max(float((l.float() - l[0:1].float()).abs().max())
                           for l in leaves(cp)))
        now = tree_digest(cp)
        check(moved_leaves(prev, now) > 0,
              f"whisper-base FSL step {i} moved nothing")
        prev = now
    counts = read_counts("whisper-base FSL step")
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses),
          f"whisper-base FSL step: losses {losses}")
    check_finite_tree("whisper-base FSL step", cp)
    print(f"whisper-base make_fsl_train_step: {m.encdec.encoder_layers} enc "
          f"+ {m.num_layers} dec layers (full size), {n} clients x B "
          f"{c['batch']} x {c['seq']} target tokens (+ "
          f"{m.encdec.encoder_seq} frames), local_steps "
          f"{c['local_steps']}: replicas' largest spread after each step "
          f"{[f'{x:.3g}' for x in spreads]} (equal bit for bit after steps "
          f"1 and 3)")
    report_train("whisper-base make_fsl_train_step",
                 n * c["batch"] * c["seq"], walls, losses, peak, counts)
    del cp, co, params, opt_state, batch
    torch.cuda.empty_cache()
    print(f"whisper-base train path: {time.perf_counter() - t0:.1f} s")

    # the kernels are forward-only: a step that asks for them is refused
    zero_counts()
    flash = get_config("qwen3-14b", "train_4k").override(
        {"parallel.use_flash_kernel": True})
    for build in (make_train_step, lambda cfg: make_fsl_train_step(cfg, 2)):
        try:
            build(flash)
        except ValueError as e:
            check("forward-only" in str(e), f"refusal says {e}")
        else:
            raise RuntimeError("a train step with use_flash_kernel was built")
    read_counts("use_flash_kernel train step")
    print("a train step built with parallel.use_flash_kernel is refused "
          "(the kernels are forward-only), no kernel launched")


def phase_train_small_reference(dev):
    """At smoke width, fp32 compute, TF32 off, SGD: one train step (2
    micro-batches) on the card against the same step on the CPU, for the
    three train paths' archs: the momentum (the clipped gradients) and the
    parameters within ``TRAIN_SMALL_TOL`` of each leaf's largest value
    (a key bias's, whose gradient is 0 analytically, of the tree's).
    Not bit for bit: the embedding's backward sums with atomics on the
    card."""
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models.transformer import lm_init
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import make_train_step
    from repro_torch.tree import leaves, tree_map

    cpu = torch.device("cpu")
    for arch, tol in TRAIN_SMALL_TOL.items():
        cfg = reduce_for_smoke(get_config(arch, "train_4k"), seq_len=32,
                               batch=4).override(
            {"optim.name": "sgd", "optim.lr": 0.1,
             "parallel.microbatches": 2})
        m = cfg.model
        params = lm_init(0, m, torch.float32, dev)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 synthetic_lm_batch(4, 32, m.vocab_size, seed=3).items()}
        if m.encdec.enabled:
            batch["enc_embeds"] = 0.1 * torch.randn(
                (4, m.encdec.encoder_seq, m.d_model),
                generator=torch.Generator(device=dev).manual_seed(3),
                device=dev)
        runs = []
        for where in (dev, cpu):
            p = tree_map(lambda t: t.to(where), params)
            b = tree_map(lambda t: t.to(where), batch)
            o = make_optimizer(cfg.optim).init(p)
            runs.append(make_train_step(cfg)(p, o, b, 0))
        (card_p, card_o, card_m), (host_p, host_o, host_m) = runs
        worst = 0.0
        for card, host in ((card_p, host_p), (card_o["mom"], host_o["mom"])):
            top = max(float(h.abs().max()) for h in leaves(host))
            for path, a, h in zip(paths(host), leaves(card), leaves(host)):
                err = float((a.cpu() - h).abs().max())
                # a key bias's gradient is 0 analytically (softmax cancels
                # q.b): its rounding noise is held against the tree's scale
                ref = top if path[-2:] == ("wk", "b") else float(
                    h.abs().max())
                worst = max(worst, err / max(ref, 1e-30))
        check(worst <= tol, f"{arch} small train step: card vs CPU {worst}")
        dl = abs(float(card_m["loss"]) - float(host_m["loss"]))
        print(f"small input, {arch} train step (SGD, 2 micro-batches), card "
              f"vs CPU: gradients and parameters within {worst:.3e} of each "
              f"leaf's largest (pin {tol}), loss diff {dl:.3e}")


# ---------------------------------------------------------------------------
# the dry run: the sharded layout on the production meshes, and against a
# real step on the card
# ---------------------------------------------------------------------------

DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun")
# (a) two pairs of the dry run, with probes
DRYRUN_PAIRS = [("qwen3-14b", "train_4k", False),
                ("llama3-405b", "decode_32k", True)]
# the probes' prediction at the traced depth against its trace
PROBE_TOL = 1e-9
# (b) the dry run against the real warm step of phase_train_paths (b)
DRYRUN_FLOPS_TOL = 1e-6
ALLOC_ROUND = 512               # the caching allocator's rounding a block


def phase_dryrun(dev):
    """The dry run (``repro_torch.launch.dryrun``; fake tensors on a fake
    CPU device, no card) and what the card says of it:
    (a) ``run_pair`` on qwen3-14b ``train_4k`` over the (16, 16) mesh and
    llama3-405b ``decode_32k`` over (2, 16, 16), with probes: status ok,
    every term finite and nonnegative, and the probes' prediction at the
    traced depth (2 periods) within ``PROBE_TOL`` of that trace's direct
    count (flops, bytes, activation elements);
    (b) ``lower_one`` of qwen3-14b at 4 of 40 layers, 8 micro-batches of
    1 x 2048, on ``make_host_mesh()`` (one card: (1, 1)), against the same
    step on the card: its flops under ``FlopCounterMode`` on the warm step
    (within ``DRYRUN_FLOPS_TOL``), the parameter and optimizer bytes
    against what the caching allocator's stats say ``lm_init`` and the
    optimizer's init took (the bytes the tensors requested within
    ``ALLOC_ROUND`` a leaf; the blocks allocated, which the allocator
    rounds, printed beside), and the activation estimate beside the warm
    step's peak above what was live before it, with their ratio;
    (c) ``fedavg_collective`` over a one-rank NCCL group on the card,
    equal bit for bit to ``fedavg`` of the one tree (the weighted form
    within 1e-6 of it).
    No kernel launches in any of them (counts set to 0 before, read
    after)."""
    import socket
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fedavg import (fedavg, fedavg_collective,
                                         fedavg_weighted_collective)
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.launch.dryrun import lower_one, run_pair
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import lm_init
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import make_train_step
    from repro_torch.tree import leaves

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0

    # (a) the two pairs
    for arch, shape, multi in DRYRUN_PAIRS:
        t0 = time.perf_counter()
        rec = run_pair(arch, shape, multi, DRYRUN_DIR, verbose=False)
        wall = time.perf_counter() - t0
        check(rec["status"] == "ok", f"dry run {arch} {shape}: {rec}")
        pt = rec["probe_terms"]
        check("error" not in pt, f"dry run {arch} {shape} probes: {pt}")
        for k in ("hlo_flops", "hlo_bytes", "collective_bytes",
                  "compute_term_s", "memory_term_s", "collective_term_s",
                  "arg_bytes_per_device", "temp_bytes_per_device",
                  "out_bytes_per_device", "param_bytes_per_device",
                  "opt_bytes_per_device"):
            v = rec[k]
            check(math.isfinite(v) and v >= 0,
                  f"dry run {arch} {shape}: {k} = {v}")
        worst = max(pt["direct_check"][k]
                    for k in ("flops", "bytes", "act", "act_chip"))
        check(worst <= PROBE_TOL, f"dry run {arch} {shape}: probes vs "
              f"direct {pt['direct_check']}")
        print(f"dry run {arch} {shape} on {rec['mesh']} ({rec['chips']} "
              f"chips; tensors {rec['tensors']}, kernels {rec['kernels']}, "
              f"use_flash_kernel {rec['use_flash_kernel']}): flops a chip "
              f"{rec['hlo_flops']:.6e}, params "
              f"{rec['param_bytes_per_device'] / 1e9:.4f} GB, opt "
              f"{rec['opt_bytes_per_device'] / 1e9:.4f} "
              f"GB, activations {rec['temp_bytes_per_device'] / 1e9:.4f} GB "
              f"a rank, collectives {rec['collective_bytes']:.6e} B, terms "
              f"compute {rec['compute_term_s']:.4e} s, memory "
              f"{rec['memory_term_s']:.4e} s, collective "
              f"{rec['collective_term_s']:.4e} s: dominant "
              f"{rec['dominant']}; traced {rec['traced_periods']} of "
              f"{rec['periods']} periods in {rec['compile_s']:.1f} s, "
              f"probes vs direct {pt['direct_check']}, pair {wall:.1f} s")

    # (b) the dry run against the real step on the card
    b = TRAIN_QWEN
    cfg = get_config("qwen3-14b", "train_4k").override({
        "model.num_layers": b["layers"], "shape.global_batch": b["batch"],
        "shape.seq_len": b["seq"]})
    m = cfg.model
    t0 = time.perf_counter()
    counts = lower_one(cfg, make_host_mesh(device_type=dev.type))
    trace_s = time.perf_counter() - t0
    check(counts.chips == 1 and counts.share == 1.0,
          f"host mesh: {counts.chips} chips, share {counts.share}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def allocated():
        """(bytes of the blocks allocated, bytes the tensors asked for)"""
        st = torch.cuda.memory_stats(dev)
        return (st["allocated_bytes.all.current"],
                st["requested_bytes.all.current"])

    base = allocated()
    params = lm_init(0, m, torch.bfloat16, dev)
    after_params = allocated()
    opt_state = make_optimizer(cfg.optim).init(params)
    after_opt = allocated()
    for label, lo, hi, want, n in (
            ("parameter", base, after_params, counts.param_bytes,
             len(leaves(params))),
            ("optimizer", after_params, after_opt, counts.opt_bytes,
             len(leaves(opt_state)))):
        got_alloc, got_req = hi[0] - lo[0], hi[1] - lo[1]
        check(abs(got_req - want) <= ALLOC_ROUND * n,
              f"dry run {label} bytes {want} vs requested {got_req} "
              f"({n} leaves)")
        print(f"dry run vs card, qwen3-14b {m.num_layers} layers: {label} "
              f"bytes {want:.0f} counted; on the card {got_req} requested "
              f"({got_req - want:+.0f} B), {got_alloc} allocated "
              f"({got_alloc - want:+.0f} B; {n} leaves, pin "
              f"{ALLOC_ROUND} B a leaf: "
              f"{'within' if abs(got_alloc - want) <= ALLOC_ROUND * n else 'outside'})")
    step = make_train_step(cfg)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                synthetic_lm_batch(b["batch"], b["seq"], m.vocab_size,
                                   seed=i).items()} for i in range(2)]
    params, opt_state, _ = step(params, opt_state, batches[0],
                                cfg.optim.warmup_steps)
    torch.cuda.synchronize()
    before = allocated()
    torch.cuda.reset_peak_memory_stats(dev)
    ts = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        params, opt_state, met = step(params, opt_state, batches[1],
                                      cfg.optim.warmup_steps + 1)
        loss = float(met["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    st = torch.cuda.memory_stats(dev)
    peak = (st["allocated_bytes.all.peak"], st["requested_bytes.all.peak"])
    card_flops = float(fc.get_total_flops())
    rel = abs(card_flops - counts.flops) / card_flops
    check(math.isfinite(loss), f"dry run check step: loss {loss}")
    check(rel <= DRYRUN_FLOPS_TOL, f"dry run flops {counts.flops} vs the "
          f"card's step {card_flops}")
    above = [p - q for p, q in zip(peak, before)]
    print(f"dry run vs card, qwen3-14b {m.num_layers} layers, "
          f"{cfg.parallel.microbatches} micro-batches of 1 x {b['seq']}: "
          f"flops {counts.flops:.6e} counted (trace {trace_s:.1f} s), "
          f"{card_flops:.6e} on the card's warm step (rel diff {rel:.2e}, "
          f"pin {DRYRUN_FLOPS_TOL}); activations {counts.temp_bytes / 1e9:.4f}"
          f" GB counted; the warm step's peak {peak[0] / 1e9:.4f} GB "
          f"allocated ({peak[1] / 1e9:.4f} GB requested) is "
          f"{above[0] / 1e9:.4f} GB ({above[1] / 1e9:.4f} GB) above what "
          f"was live before it, {before[0] / 1e9:.4f} GB: ratio counted / "
          f"measured {counts.temp_bytes / above[0]:.4f} allocated, "
          f"{counts.temp_bytes / above[1]:.4f} requested; warm step under "
          f"FlopCounterMode {wall:.3f} s")
    del params, opt_state, batches
    torch.cuda.empty_cache()

    # (c) the collective FedAvg on a one-rank NCCL group
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0, device_id=dev)
    try:
        gen = torch.Generator(device=dev).manual_seed(7)
        tree = {"w": torch.randn((4096, 1024), generator=gen, device=dev),
                "b": {"x": torch.randn((1000,), generator=gen, device=dev),
                      "h": torch.randn((512, 256), generator=gen,
                                       device=dev).to(torch.bfloat16)}}
        got, want = fedavg_collective(tree), fedavg([tree])
        same = all(torch.equal(g, w) for g, w in zip(leaves(got),
                                                     leaves(want)))
        check(same, "fedavg_collective on one rank differs from fedavg")
        wgot = fedavg_weighted_collective(tree, 2.5)
        werr = max(float((g.float() - w.float()).abs().max())
                   for g, w in zip(leaves(wgot), leaves(want)))
        check(werr <= 1e-6 * max(float(w.float().abs().max())
                                 for w in leaves(want)),
              f"fedavg_weighted_collective on one rank: {werr}")
    finally:
        dist.destroy_process_group()
    counts_now = {k: w.launches for k, w in wrappers.items() if w.launches}
    check(not counts_now, f"dry run phase: kernel launches {counts_now}")
    print(f"fedavg_collective on a one-rank NCCL group: bit for bit "
          f"fedavg's ({len(leaves(tree))} leaves, fp32 and bf16); the "
          f"weighted form within {werr:.3e}; no kernel launched in the "
          f"dry-run phase")


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
    # cuDNN's TF32 flag stays at PyTorch's default: the trainer's entry
    # points turn it off for their convolutions themselves.  The LM paths'
    # fp32 matmuls need cuBLAS's TF32 off (PyTorch's default too)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(dev)}, "
          f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({secs})")
    for name in build.SOURCES:
        print(f"nvcc report for {name}:\n{build.build_log(name).strip()}")

    t0 = time.perf_counter()
    rows = [phase_fedavg(dev), phase_dp_clip(dev),
            phase_boundary_fuse(dev), *phase_agg_fuse(dev),
            phase_flash_attention(dev), phase_wkv6(dev)]
    print(f"kernel vs plain: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, by_path = phase_main_paths(dev)
    print(f"main paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    adaptive = phase_adaptive_path(dev)
    for name, n in adaptive.items():
        if n:
            by_path.setdefault(name, {})["adaptive path"] = n
    print(f"adaptive path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in phase_attack_path(dev).items():
        if n:
            by_path.setdefault(name, {})["attack path"] = n
    print(f"attack path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_launches, lm_by_path = phase_lm_paths(dev)
    launches.update(lm_launches)
    by_path.update(lm_by_path)
    print(f"LM paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_paths(dev)
    print(f"train paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_dryrun(dev)
    print(f"dry run: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["name"] in by_path:
            row["launches_by_path"] = by_path[row["name"]]
    t0 = time.perf_counter()
    phase_small_reference(dev)
    phase_small_split_reference(dev)
    phase_small_vectorized_reference(dev)
    phase_small_adaptive_reference(dev)
    phase_small_attack_reference(dev)
    phase_lm_small_reference(dev)
    phase_train_small_reference(dev)
    print(f"small references: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
