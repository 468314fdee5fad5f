#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the GPUs the cell asks for.
Set-up (process start to the first timed step: imports, the kernels'
build or load from ``build/kernels``, weights and data from the seed, the
first ``check_steps`` steps, which warm up every shape) is ``setup_s``.
Then the window: steps back to back for ``--seconds``, each ending in a
device synchronise.  With ``--trace 1`` a fixed slice of the window
(``trace_start`` .. ``trace_start + trace_steps`` of the traffic file) runs
under ``torch.profiler``, the window's other steps run with the layer
spans on, and the per-layer metrics are read from both instead of the
end-to-end ones: device times from the slice, rates and spans from the
untraced steps (the profiler slows the host).  After the window
the program's state is freed and the plain reference follows the first
``check_steps`` steps from the same weights and inputs; ``correct`` holds
when every compared number is within its limit (``limits/<cell>.json``).

The last line of standard output is one JSON object.  A run exits 2 with no
result where CUDA is missing or has fewer devices than the cell asks for,
and 3 where a module of JAX or of the JAX package is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == _HERE:
    sys.path.pop(0)          # the package's modules are perfbench.<name>
sys.path[:0] = [str(_HERE.parent), str(_HERE.parent / "src")]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_window(sess, traffic, seconds: float, trace: bool):
    """Steps back to back for ``seconds`` (and, traced, until the slice is
    done).  Returns the window's record for the metric readers.

    A traced run profiles the slice's steps and times the layer spans of
    all its other steps with CUDA events alone: the profiler slows the
    host's launches (by 9-37% a round where a round launches many small
    kernels, on H100 hosts), so the rates and spans of the per-layer metrics are read
    from the untraced steps, and the trace gives only device times."""
    import torch
    from perfbench import trace as tr

    k0 = int(traffic.get("trace_start", 1))
    k1 = k0 + int(traffic["trace_steps"])
    spans = tr.Spans()
    saved = spans.install(sess.span_points()) if trace else []
    prof, prof_cm = None, None
    steps = failed = 0
    walls = []                   # (seconds, traced) of each step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        while True:
            traced = trace and k0 <= steps < k1
            if traced and steps == k0:
                prof_cm = tr.profiled()
                prof = prof_cm.__enter__()
            spans.phase = ("traced" if traced else "timed") if trace else None
            a = time.perf_counter()
            with (spans.host_span("step") if traced
                  else contextlib.nullcontext()):
                ok = sess.step()
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - a, traced))
            spans.phase = None
            steps += 1
            failed += 0 if ok else 1
            if traced and steps == k1:
                prof_cm.__exit__(None, None, None)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and (not trace or steps >= k1):
                break
    finally:
        tr.Spans.restore(saved)
    ws = sorted(w for w, _ in walls)
    print(f"{sess.unit}s: {steps}; wall a {sess.unit} (s): min {ws[0]!r}, "
          f"median {ws[len(ws) // 2]!r}, max {ws[-1]!r}", file=sys.stderr)
    ctx = {"window_s": elapsed, "steps": steps, "failed": failed,
           "tokens": steps * sess.tokens_per_step(), "session": sess,
           "trace": None, "spans_ms": {}}
    if trace:
        untraced = [w for w, t in walls if not t]
        traced_walls = [w for w, t in walls if t]
        labels = spans.labels(prof["base_ns"])
        steps_lab = [lab for lab in labels if lab[0] == "step"]
        s0 = min(ts for _, ts, _ in steps_lab)
        s1 = max(ts + dur for _, ts, dur in steps_lab)
        bd = tr.breakdown(prof["device"], labels, s0, s1)
        ctx["trace"] = {
            "slice_s": (s1 - s0) / 1e6, "slice_steps": k1 - k0,
            "busy_s": bd["busy_s"], "device": prof["device"],
            "labels": labels,
            # the untraced steps of this run: the per-layer rates' time
            "step_s": sum(untraced) / len(untraced) if untraced else None,
            "timed_steps": len(untraced),
            "breakdown": {"device_ops": bd["device_ops"],
                          "idle_gaps": bd["idle_gaps"]}}
        ctx["spans_ms"] = spans.ms("timed")
        print(f"traced slice: {sum(traced_walls) / len(traced_walls)!r} s "
              f"a {sess.unit} over {len(traced_walls)}; untraced: "
              f"{ctx['trace']['step_s']!r} s a {sess.unit} over "
              f"{len(untraced)}; device busy "
              f"{bd['busy_s'] / (k1 - k0)!r} s a {sess.unit}",
              file=sys.stderr)
    return ctx


def forbidden_modules():
    from perfbench.common import FORBIDDEN_MODULES
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import common
    common.env_for_checkout()
    import torch

    spec = common.resolve_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()} (CUDA available: "
              f"{torch.cuda.is_available()})", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - T_START
    sess = common.driver(spec["config"]["driver"]).Session(
        spec, args.seed, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    print(f"setup parts (s): start to CUDA {t_cuda!r}, "
          + ", ".join(f"{k} {v!r}" for k, v in sess.marks.parts.items()),
          file=sys.stderr)
    ctx = run_window(sess, spec["traffic"], args.seconds, bool(args.trace))
    ctx["setup_s"] = setup_s
    peak = int(torch.cuda.max_memory_allocated(dev))

    metrics = {}
    for m in spec["layer"] if args.trace else spec["e2e"]:
        value = common.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": peak}
    if ctx["trace"] is not None:
        device["busy_s"] = ctx["trace"]["busy_s"]
        device["window_s"] = ctx["trace"]["slice_s"]

    sess.release()
    values = common.readings(sess.record, sess.reference_record())
    ok, checks = common.judge(values, spec["limits"])
    correct = bool(ok and ctx["failed"] == 0 and ctx["steps"] > 0
                   and all(math.isfinite(v["value"])
                           for v in metrics.values()))
    result = {"correct": correct, "attempted": ctx["steps"],
              "failed": ctx["failed"], "metrics": metrics, "device": device}
    if ctx["trace"] is not None:
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
