#!/usr/bin/env python3
"""Where the time goes on the port's LM paths, on one NVIDIA GPU.

    python3 profile_lm.py [--arch qwen3-14b rwkv6-1.6b]

For each architecture at full width (random weights from seed 0): serving
as ``chip_smoke.py`` drives it (4 requests of 128-1024 prompt tokens, 16
greedy tokens, bf16 cache) twice, with the prefill time and every decode
step's time (host clock, each step ending in a host read of the tokens);
then the ``lm_loss`` forward (qwen3-14b B 2 x S 2048, rwkv6-1.6b B 4 x
T 2048) warm, through the kernels and through the plain path.  Two decode
steps, the qwen3-14b prefill and the forward through the kernels are
traced with ``torch.profiler``: for each, the trace window, the time some
kernel was running (the union of the kernels' intervals) and its share of
the window, the number of kernel launches, and the kernels that take the
most time.  The profiler's own cost is inside the window, so the busy
share is a lower bound.
"""
import argparse
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


def busy(prof, label, top=8):
    """Kernel busy time and share of the traced window, from the trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    timed = [e for e in events if "ts" in e and "dur" in e]
    kernels = [e for e in timed if e.get("cat") == "kernel"]
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
        for use_kernel in (True, False):
            lm_loss(params, fwd, m, cd, use_kernel=use_kernel)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_loss(params, fwd, m, cd, use_kernel=use_kernel)
            torch.cuda.synchronize()
            print(f"{arch} lm_loss forward B {b} x S {s}, use_kernel="
                  f"{use_kernel}: warm wall {time.perf_counter() - t0:.3f} s")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lm_loss(params, fwd, m, cd, use_kernel=True)
            torch.cuda.synchronize()
        busy(prof, f"{arch} forward through the kernels")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(FORWARD),
                    choices=list(FORWARD))
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
    for arch in args.arch:
        profile_arch(arch, dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
