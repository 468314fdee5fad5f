"""What the per-layer metrics of the program's own spans read: the host
spans and host-sync counts that ``repro_torch/obs/trace.py`` records inside
the FSL-GAN round and the LM train step, on the system clock that the
profiler's trace counts from.

The window runs with the program's tracing off, so on its first call for
a session (after the window, before the session is released) :func:`read`
runs the traffic's ``trace_steps`` more steps twice with the program's
tracer active: once without a profiler, for each span's device extent
(its CUDA event pair), host time and host syncs, free of CUPTI's host
slowdown; once under ``torch.profiler`` (CUDA activity), where each device
operation is charged to the innermost span open when the host launched it
(the operation's ``correlation`` with its ``cuda_runtime`` or
``cuda_driver`` launch event).  The summary is cached on the session.  A
program without these spans (no ``tracing`` in ``repro_torch.obs.trace``)
gives None and runs no step.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench.trace import DEVICE_CATS, busy_union

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def read(ctx) -> Optional[Dict[str, Any]]:
    """The session's span summary (:func:`summarise`), measured on the
    first call of a traced run; None in an untraced run or where the
    program records no spans."""
    if ctx["trace"] is None:
        return None
    sess = ctx["session"]
    if not hasattr(sess, "program_trace"):
        sess.program_trace = measure(sess)
    return sess.program_trace


def measure(sess) -> Optional[Dict[str, Any]]:
    try:
        from repro_torch.obs.trace import Tracer, tracing
    except ImportError:          # a program that places no spans
        return None
    n = int(sess.traffic["trace_steps"])
    timed = Tracer("timed")
    with tracing(timed, device_events=True, count_syncs=True):
        for _ in range(n):
            sess.step()
    if not timed.spans:
        return None
    profiled = Tracer("profiled")
    with launches() as prof:
        with tracing(profiled):
            for _ in range(n):
                sess.step()
        torch.cuda.synchronize()
    out = summarise(timed, profiled, prof, n)
    out["unit"] = sess.unit
    print("program spans, a " + sess.unit + " (name: count, device extent "
          "ms, busy ms, host ms, syncs, kernels charged): " + "; ".join(
              f"{k}: {v['count']!r}, {v['extent_ms']!r}, {v['busy_ms']!r}, "
              f"{v['host_ms']!r}, {v['syncs']!r}, {v['kernels']!r}"
              for k, v in out["spans"].items())
          + f"; syncs a {sess.unit} {out['syncs_by_step']}, outside spans "
          f"{timed.syncs_outside}; device operations {out['operations']}, "
          f"outside spans {out['uncharged']} {out['outside'][:4]}, launch "
          f"not found {out['unmatched']}", file=sys.stderr)
    return out


@contextlib.contextmanager
def launches():
    """Profile the block's device activity; yields a dict that holds,
    after the block, each device operation as ``(launch, start, end,
    name)``, times in ns on the system clock (``ops``, in launch order;
    the launch from the operation's runtime or driver launch event, or its
    own start where none is found, counted in ``unmatched``).  A build of
    PyTorch without CUDA has no device operation to profile."""
    out: Dict[str, Any] = {"ops": [], "unmatched": 0}
    if torch.version.cuda is None:
        yield out
        return
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield out
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    launch: Dict[Any, float] = {}
    device = []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launch[corr] = float(e["ts"])
        elif e.get("cat") in DEVICE_CATS:
            device.append((corr, float(e["ts"]), float(e["dur"]),
                           e["name"]))
    ops = []
    for corr, ts, dur, name in device:
        at = launch.get(corr)
        if at is None:
            out["unmatched"] += 1
            at = ts
        ops.append((base + at * 1e3, base + ts * 1e3,
                    base + (ts + dur) * 1e3, name[:80]))
    out["ops"] = sorted(ops)


def charge(spans: List[Tuple[int, int, int]], at: List[float]
           ) -> List[Optional[int]]:
    """For each time in ``at`` (sorted), the id of the innermost span of
    ``spans`` (``(id, start, end)``, properly nested) open at it, or
    None."""
    events = sorted([(s0, 0, sid) for sid, s0, _ in spans]
                    + [(s1, 2, sid) for sid, _, s1 in spans]
                    + [(t, 1, i) for i, t in enumerate(at)])
    stack: List[int] = []
    out: List[Optional[int]] = [None] * len(at)
    for _, kind, x in events:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            stack.remove(x)
        else:
            out[x] = stack[-1] if stack else None
    return out


def summarise(timed, profiled, prof: Dict[str, Any], steps: int
              ) -> Dict[str, Any]:
    """Each span name's mean a step: ``count``, ``extent_ms`` (device
    extents, CUDA events), ``host_ms`` and ``syncs`` from the ``timed``
    tracer's steps; ``busy_ms`` (the busy union of the device operations
    launched inside each span, children included) and ``kernels`` (those
    charged to it as the innermost span) from the ``profiled`` tracer's
    steps and ``prof`` (:func:`launches`).  Also the syncs of each step
    (all spans), and how many device operations were launched outside
    every span (``uncharged``, a step; ``outside``, their names)."""
    names: Dict[str, Dict[str, float]] = {}

    def entry(name):
        return names.setdefault(name, {
            "count": 0, "extent_ms": 0.0, "busy_ms": 0.0, "host_ms": 0.0,
            "syncs": 0, "kernels": 0})

    extents = timed.device_ms()
    by_step: Dict[Any, int] = {}
    for s in timed.spans:
        e = entry(s.name)
        e["count"] += 1
        e["extent_ms"] += extents.get(s.span_id, 0.0)
        e["host_ms"] += (s.wall_end - s.wall_start) * 1e3
        e["syncs"] += s.syncs
        by_step[s.index] = by_step.get(s.index, 0) + s.syncs
    ops = prof["ops"]
    at = [op[0] for op in ops]
    spans = [(s.span_id, *profiled.wall_ns(s)) for s in profiled.spans]
    name_of = {s.span_id: s.name for s in profiled.spans}
    for sid, s0, s1 in spans:
        lo, hi = bisect.bisect_left(at, s0), bisect.bisect_right(at, s1)
        busy, _ = busy_union([op[1:3] for op in ops[lo:hi]])
        entry(name_of[sid])["busy_ms"] += busy / 1e6
    owner = charge(spans, at)
    for sid in owner:
        if sid is not None:
            entry(name_of[sid])["kernels"] += 1
    for e in names.values():
        for k in e:
            e[k] /= steps
    outside = [op[3] for op, sid in zip(ops, owner) if sid is None]
    return {"spans": names, "syncs_by_step": list(by_step.values()),
            "operations": len(ops) / steps,
            "uncharged": len(outside) / steps, "outside": outside,
            "unmatched": prof["unmatched"] / steps}
