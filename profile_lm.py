#!/usr/bin/env python3
"""Where the time goes on the port's LM paths and inside its dp_clip,
wkv6, boundary_fuse and agg_fuse kernels, on one NVIDIA GPU.

    python3 profile_lm.py [--arch qwen3-14b rwkv6-1.6b ...] [--kernels]

For each architecture at full width (random weights from seed 0), at the
depth and on the batches ``chip_smoke.py``'s ``LM_PATHS`` give it
(qwen2-72b at 32 of 80 layers, llama3-405b at 8 of 126; whisper's frame
embeddings, chameleon's interleaved image tokens): serving as
``chip_smoke.py`` drives it (4 requests of 128-1024 prompt tokens,
32-400 for whisper, 16 greedy tokens, bf16 cache) twice, with the
prefill time and every decode step's time (host clock, each step ending
in a host read of the tokens); then the ``lm_loss`` forward (B 2 x S
2048; rwkv6-1.6b B 4 x T 2048, whisper B 2 x S 448) warm, through the
kernels and through the plain path, with the loss of each.  Two decode steps, the qwen3-14b prefill and the forward
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
tensor-wide and the per-row amax, scatter_acc over a round's top-k folds
(5 clients x the 12 D leaves, K = 1% of each), dequant_acc over a
round's int8 folds, and a round's int8 ``batched_reduce`` (the
dequant_reduce launches and whatever the checkout does around them), each
with its eager time (CUDA events around back-to-back calls, host
dispatch included).  The script measures the checkout it sits in: a copy
of it in another checkout measures that one (where that checkout's
boundary_fuse has no amax mode it is timed with the tensor-wide amax
alone, and where its agg_fuse has no leaf table the folds are timed one
launch a leaf).
``--arch`` with no name skips the architectures.

``--train ARCH`` (rwkv6-1.6b, qwen3-14b or whisper-base) drives that
arch's train path of ``chip_smoke.py`` at its size (``TRAIN_RWKV``,
``TRAIN_QWEN``, ``TRAIN_WHISPER``: the train step, for whisper the FSL
step over its clients): a cold step, a warm step timed, and one more
traced with ``torch.profiler`` (CUDA activity only: an rwkv6 step
launches some 10^6 kernels), with its busy share and top device times.
Then the parts the step is made of, at the step's shapes, each as a
share of the warm step: the
plain WKV loop (one layer's forward and backward through autograd, plus
the checkpoint's second forward, times the layers) and the head product
(final norm, the fp32 vocabulary product and the log-softmax, forward and
backward, once a micro-batch), each timed alone and scaled by its count
(an estimate: the traced step's kernels are not attributed to parts, and
eager parts alone need not add up as they do inside the step); and the
AdamW update,
timed inside the warm step by CUDA events around each update call.
"""
import argparse
import contextlib
import functools
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

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


def d_leaf_sizes():
    """The dcgan-mnist discriminator's 12 leaf sizes at full width."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.dcgan import disc_init
    from repro_torch.tree import leaves

    return [l.numel() for l in leaves(disc_init(
        torch.Generator().manual_seed(0),
        get_config("dcgan-mnist").model.dcgan, "meta"))]


def encoded_round(dev, codec_name):
    """A round's uplinks through the codec: 5 clients x the 12 D leaves,
    each a delta about the size of two Adam steps."""
    from repro_torch.fed.transport import make_codec

    gen = torch.Generator(device=dev).manual_seed(4)
    codec = make_codec(codec_name)
    return [[codec.encode(torch.randn((n,), generator=gen, device=dev)
                          * 4e-4) for n in d_leaf_sizes()]
            for _ in range(DP_CLIENTS)]


def scatter_acc_case(dev):
    """(label, call) of scatter_acc over a round's top-k folds: 5 clients
    x the 12 D leaves, one launch a fold where the checkout has the leaf
    table, else one a leaf."""
    from repro_torch.kernels.agg_fuse import kernel

    sizes = d_leaf_sizes()
    accs = [torch.zeros((n,), device=dev) for n in sizes]
    folds = [([v for (v, _), _ in enc], [i for (_, i), _ in enc], 0.5 + 0.1 * c)
             for c, enc in enumerate(encoded_round(dev, "topk"))]
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


def dequant_acc_case(dev):
    """(label, call) of dequant_acc over a round's int8 folds: 5 clients x
    the 12 D leaves, one launch a fold where the checkout has the leaf
    table, else one a leaf."""
    from repro_torch.kernels.agg_fuse import kernel

    sizes = d_leaf_sizes()
    accs = [torch.zeros((n,), device=dev) for n in sizes]
    folds = [([x for x, _ in enc], [s for _, s in enc], 0.5 + 0.1 * c)
             for c, enc in enumerate(encoded_round(dev, "int8"))]
    if hasattr(kernel, "dequant_acc_leaves_kernel"):
        def call():
            for wires, scales, w in folds:
                kernel.dequant_acc_leaves_kernel(accs, wires, w, scales)
        how = "one launch a fold"
    else:
        def call():
            for wires, scales, w in folds:
                for a, x, sc in zip(accs, wires, scales):
                    kernel.dequant_acc_kernel(a, x, w, sc)
        how = "one launch a leaf"
    return (f"dequant_acc, a round's {len(folds)} int8 folds of "
            f"{len(sizes)} leaves, {how}", call)


def batched_reduce_case(dev):
    """(label, call) of a round's batched int8 reduce through
    ``fed.aggregate.batched_reduce`` as the checkout has it: 5 clients'
    uplinks of the 12 D leaves (one launch over the wires in place, or a
    stack and a launch a leaf)."""
    from repro_torch.fed.aggregate import batched_reduce

    sizes = d_leaf_sizes()
    encs = encoded_round(dev, "int8")
    template = {f"{k:02d}": torch.zeros((n,), device=dev)
                for k, n in enumerate(sizes)}
    weights = [0.5 + 0.1 * c for c in range(len(encs))]
    return (f"batched_reduce, a round's int8 reduce of {len(encs)} clients "
            f"x {len(sizes)} leaves",
            lambda: batched_reduce("int8", encs, weights, template,
                                   use_kernel=True))


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
    from chip_smoke import LM_FWD, LM_PATHS, lm_forward_batch, plain_attention
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.models.frontends import audio_frame_embeddings
    from repro_torch.models.transformer import lm_init, lm_loss
    from repro_torch.runtime import make_decode_step, make_prefill_step
    from repro_torch.runtime.serve import _dtype

    path = LM_PATHS[arch]
    cfg = get_config(arch, "decode_32k")
    if path.get("layers"):
        cfg = cfg.override({"model.num_layers": path["layers"]})
        print(f"{arch}: {path['layers']} layers (cut: {path['cut']})")
    m = cfg.model
    params = lm_init(0, m, _dtype(cfg.parallel.param_dtype), dev)
    rng = np.random.default_rng(0)
    lo, hi = path.get("prompts", (128, 1025))
    lens = [int(n) for n in rng.integers(lo, hi, REQUESTS)]
    max_len = max(lens)
    toks = np.zeros((REQUESTS, max_len), np.int32)
    for i, n in enumerate(lens):       # left-padded, as serve_batch does
        toks[i, max_len - n:] = synthetic_tokens(1, n, m.vocab_size,
                                                 seed=i)[0]
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    if m.encdec.enabled:
        batch["enc_embeds"] = audio_frame_embeddings(
            torch.Generator(device=dev).manual_seed(0), REQUESTS, m)
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
        b, s = path.get("fwd", LM_FWD)
        fwd = lm_forward_batch(dev, m, b, s)
        losses = {}
        for use_kernel in (True, False):
            with (contextlib.nullcontext() if use_kernel
                  else plain_attention()):
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


def train_setup(arch, dev, updates):
    """-> (cfg, params, opt_state, step, batch, step_idx, clients) of the
    arch's train path in ``chip_smoke.py`` (clients 0: not FSL).  The
    step's optimizer appends a (start, end) pair of CUDA events around
    each of its update calls to ``updates``."""
    from chip_smoke import TRAIN_QWEN, TRAIN_RWKV, TRAIN_WHISPER
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models.frontends import audio_frame_embeddings
    from repro_torch.models.transformer import lm_init
    from repro_torch.optim import Optimizer, make_optimizer
    from repro_torch.runtime import make_fsl_train_step, make_train_step
    from repro_torch.runtime import train as RT
    from repro_torch.runtime.serve import _dtype
    from repro_torch.tree import tree_map

    size = {"rwkv6-1.6b": TRAIN_RWKV, "qwen3-14b": TRAIN_QWEN,
            "whisper-base": TRAIN_WHISPER}[arch]
    over = {"shape.global_batch": size["batch"], "shape.seq_len": size["seq"]}
    if "layers" in size:
        over["model.num_layers"] = size["layers"]
    clients = size.get("clients", 0)
    if clients:
        over["fsl.local_steps"] = size["local_steps"]
    cfg = get_config(arch, "train_4k").override(over)
    m = cfg.model
    params = lm_init(0, m, _dtype(cfg.parallel.param_dtype), dev)
    opt_state = make_optimizer(cfg.optim).init(params)
    n = max(1, clients)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             synthetic_lm_batch(n * size["batch"], size["seq"],
                                m.vocab_size, seed=0).items()}
    if m.encdec.enabled:
        batch["enc_embeds"] = audio_frame_embeddings(
            torch.Generator(device=dev).manual_seed(0), n * size["batch"], m,
            _dtype(cfg.parallel.compute_dtype))
    def timed_optimizer(ocfg):
        opt = make_optimizer(ocfg)

        def update(*args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = opt.update(*args)
            end.record()
            updates.append((start, end))
            return out
        return Optimizer(init=opt.init, update=update)

    if clients:
        params = tree_map(lambda x: x[None].expand(n, *x.shape), params)
        opt_state = tree_map(lambda x: x[None].expand(n, *x.shape),
                             opt_state)
        batch = tree_map(lambda x: x.reshape(n, size["batch"],
                                             *x.shape[1:]), batch)
    with mock.patch.object(RT, "make_optimizer", timed_optimizer):
        step = make_fsl_train_step(cfg, n) if clients \
            else make_train_step(cfg)
    idx = cfg.optim.warmup_steps if arch == "qwen3-14b" else 0
    return cfg, params, opt_state, step, batch, idx, clients


def profile_train(arch, dev):
    """One warm train step of ``arch``'s path in ``chip_smoke.py``: wall,
    tokens a second, a traced step's busy share and top kernels, and the
    shares of the WKV loop, the head product and AdamW (see the module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import rwkv6
    from repro_torch.models.transformer import _head
    from repro_torch.runtime.serve import _dtype
    from repro_torch.tree import tree_map

    updates = []
    cfg, params, opt_state, step, batch, idx, clients = train_setup(
        arch, dev, updates)
    m = cfg.model
    tokens = batch["tokens"].numel()
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for i in range(2):
        updates.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = step(params, opt_state, batch, idx + i)
        float(met["loss"])
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    warm = walls[-1]
    if not updates:
        raise RuntimeError("the train step did not call the timed optimizer "
                           "(runtime.train no longer looks up "
                           "make_optimizer by that name)")
    adam_s = sum(a.elapsed_time(b) for a, b in updates) / 1e3
    print(f"{arch} {'FSL ' if clients else ''}train step ({tokens} tokens): "
          f"cold {walls[0]:.3f} s, warm {warm:.3f} s = {tokens / warm:.0f} "
          f"tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, opt_state, met = step(params, opt_state, batch, idx + 2)
        float(met["loss"])
    busy(prof, f"{arch} traced warm train step", top=12)
    del prof, met, opt_state

    one = tree_map(lambda x: x[0], params) if clients else params
    clients = max(1, clients)
    nmb = max(1, cfg.parallel.microbatches)
    mb = batch["tokens"].shape[-2] // nmb
    seq = batch["tokens"].shape[-1]
    cd = _dtype(cfg.parallel.compute_dtype)
    parts = {}
    if m.rwkv.head_dim and m.family == "ssm":
        n = m.rwkv.head_dim
        h = m.d_model // n
        g = torch.Generator(device=dev).manual_seed(0)
        r, k, v = (torch.randn((mb, seq, h, n), generator=g, device=dev,
                               requires_grad=True) for _ in range(3))
        w = torch.rand((mb, seq, h, n), generator=g, device=dev) \
            .requires_grad_(True)
        u = torch.randn((h, n), generator=g, device=dev, requires_grad=True)

        def wkv_fwd_bwd():
            out, _ = rwkv6.wkv6_scan(r, k, v, w, u, n)
            out.sum().backward()

        def wkv_fwd():
            with torch.no_grad():
                rwkv6.wkv6_scan(r, k, v, w, u, n)
        parts["WKV loop (timed alone, x layers: an estimate)"] = (
            eager_ms(wkv_fwd_bwd, 1) + eager_ms(wkv_fwd, 1)) \
            * m.num_layers * nmb * clients / 1e3
        del r, k, v, w, u
    x = torch.randn((mb, seq, m.d_model), device=dev, dtype=cd,
                    requires_grad=True)
    hp = {k: one[k] for k in ("final_norm", "embed", "head") if k in one}
    hp = tree_map(lambda t: t.detach().requires_grad_(True), hp)
    labels = batch["labels"].reshape(-1, seq)[:mb].long()

    def head_fwd_bwd():
        logits = _head(hp, x, m)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels[..., None])[..., 0]
        (lse - picked).mean().backward()
    parts["head product (timed alone, x micro-batches: an estimate)"] = \
        eager_ms(
            head_fwd_bwd, 3) * nmb * clients / 1e3
    parts["AdamW update (in the warm step, CUDA events)"] = adam_s
    for name, sec in parts.items():
        print(f"{arch} train step: {name} {sec:.3f} s = {sec / warm:.3f} "
              f"of the warm step")


def main() -> int:
    ap = argparse.ArgumentParser()
    from chip_smoke import LM_PATHS
    ap.add_argument("--arch", nargs="*", default=["qwen3-14b", "rwkv6-1.6b"],
                    choices=list(LM_PATHS))
    ap.add_argument("--train", nargs="*", default=[],
                    choices=["rwkv6-1.6b", "qwen3-14b", "whisper-base"],
                    help="trace a warm train step of these chip_smoke.py "
                         "train paths")
    ap.add_argument("--kernels", action="store_true",
                    help="trace the dp_clip, wkv6, boundary_fuse and "
                         "agg_fuse kernels first")
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
        cases = boundary_fuse_cases(dev) + [
            scatter_acc_case(dev), dequant_acc_case(dev),
            batched_reduce_case(dev)]
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
    for arch in args.train:
        profile_train(arch, dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
