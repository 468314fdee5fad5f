"""What a traced run reads: device kernel intervals from ``torch.profiler``
(CUPTI, device activity only: recording every host operator of a
vmapped round doubled its time), the host's layer spans, the busy union
and the breakdown.

Spans are recorded from the benchmark's own files: a wrapped call into a
layer of the program records CUDA events around itself and, in the
profiled slice, its host times on the system clock, which is the clock
the profiler's trace counts from (``baseTimeNanoseconds``), so the trace
can say what the host was doing during each idle gap of the device.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_union(intervals: Sequence[Tuple[float, float]]
               ) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length of the union of ``(start, end)`` intervals, and the
    merged intervals in order (the arithmetic of ``profile_lm.busy``)."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


class Spans:
    """CUDA events around wrapped calls, by phase and label, and host times
    (system clock) of the calls in the traced phase.

    ``phase`` is ``None`` (nothing recorded), ``"traced"`` (the profiled
    slice: events and host spans, which name the trace's idle gaps) or
    ``"timed"`` (the window's other steps: events only, so that a span's
    time is not the profiler's)."""

    def __init__(self):
        self.events: Dict[str, Dict[str, List[Tuple[Any, Any]]]] = {}
        self.host: List[Tuple[str, int, int]] = []   # label, start, end ns
        self.phase: Optional[str] = None

    @contextlib.contextmanager
    def host_span(self, label: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.host.append((label, t0, time.time_ns()))

    def wrap(self, label: str, fn):
        spans = self

        def wrapped(*args, **kwargs):
            phase = spans.phase
            if phase is None:
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            host = (spans.host_span(label) if phase == "traced"
                    else contextlib.nullcontext())
            with host:
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            spans.events.setdefault(phase, {}).setdefault(
                label, []).append((start, end))
            return out
        return wrapped

    def labels(self, base_ns: int) -> List[Tuple[str, float, float]]:
        """The host spans as ``(label, start, duration)`` in microseconds
        from the trace's base time."""
        return [(n, (a - base_ns) / 1e3, (b - a) / 1e3)
                for n, a, b in self.host]

    def install(self, points) -> List[Tuple[Any, str, Any]]:
        """Wrap ``(label, owner, attribute)`` points; returns what to
        restore."""
        saved = []
        for label, owner, attr in points:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, self.wrap(label, fn))
        return saved

    @staticmethod
    def restore(saved) -> None:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)

    def ms(self, phase: str) -> Dict[str, List[float]]:
        """Each label's span times in ms, in one phase."""
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.events.get(phase, {}).items()}


@contextlib.contextmanager
def profiled(activities=("CUDA",), cats=DEVICE_CATS):
    """Profile the block's device activity; yields a dict that holds,
    after the block, the device intervals (``device``: name, start and
    duration in microseconds from ``base_ns``) and the trace's base time
    on the system clock (``base_ns``)."""
    out: Dict[str, Any] = {}
    acts = [getattr(torch.profiler.ProfilerActivity, a) for a in activities]
    with torch.profiler.profile(activities=acts) as prof:
        yield out
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    timed = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and "dur" in e]
    out["device"] = [(e["name"], float(e["ts"]), float(e["dur"]))
                     for e in timed if e.get("cat") in cats]
    out["base_ns"] = int(trace["baseTimeNanoseconds"])


def breakdown(device: List[Tuple[str, float, float]],
              labels: List[Tuple[str, float, float]], t0: float, t1: float,
              top: int = 10) -> Dict[str, Any]:
    """The device operations that took most time in ``[t0, t1]`` and the
    longest idle gaps there, each gap named by the innermost wrapped call
    the host was in when the gap began (``host`` when none)."""
    by_name: Dict[str, float] = {}
    ivs = []
    for name, ts, dur in device:
        s, e = max(ts, t0), min(ts + dur, t1)
        if e <= s:
            continue
        key = name[:160]
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
        ivs.append((s, e))
    busy_us, merged = busy_union(ivs)
    gaps = []
    prev = t0
    for s, e in merged + [(t1, t1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)

    def host_at(t: float) -> str:
        best: Optional[Tuple[float, str]] = None
        for name, ts, dur in labels:
            if ts <= t <= ts + dur and (best is None or dur < best[0]):
                best = (dur, name)
        return best[1] if best else "host"

    named = sorted(((host_at(s), (e - s) / 1e6) for s, e in gaps),
                   key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_us / 1e6,
            "device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in named[:top]]}
