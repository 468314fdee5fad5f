"""Two-clock span tracing for the federated split engine.  Port of
``repro/obs/trace.py`` (pure Python, copied).

The engine advances a *virtual* clock (the paper's analytic time model:
download + segment compute + LAN hops + uplink), while the tensor math runs
on the host in *wall* time.  A :class:`Span` therefore carries both clocks:
``v_start``/``v_end`` in virtual seconds (NaN when the span is wall-only)
and ``wall_start``/``wall_end`` in host seconds (NaN when the span was
placed retroactively from priced times — the engine knows a client's whole
virtual timeline the moment it schedules it, so most spans are recorded
with :meth:`Tracer.record` rather than timed live).

Hierarchy is explicit: every span holds its parent's id, so round ->
client-execution -> split-segment -> boundary-crossing nests exactly the
way the engine composed the round, and a trace viewer shows the LAN hops
inside the compute window they actually occupy.

:func:`to_chrome` exports the Chrome-trace / Perfetto JSON object model
(``{"traceEvents": [...]}``, "X" complete events, one pid per clock, one
tid lane per track), loadable in ``ui.perfetto.dev`` or
``chrome://tracing``; :func:`validate_chrome_trace` is the schema check CI
runs on the exported file.
"""
from __future__ import annotations

import json
import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

NAN = float("nan")

# Chrome-trace pids: one synthetic "process" per clock, so both timelines
# coexist in one file without colliding timestamps.
PID_VIRTUAL = 1
PID_WALL = 2

TRACE_CLOCKS = ("virtual", "wall", "both")


@dataclass(frozen=True)
class Span:
    """One named interval on one track, on one or both clocks."""
    span_id: int
    parent_id: Optional[int]
    name: str
    cat: str                      # coarse kind: round|client|segment|...
    track: str                    # viewer lane (client id, device id, server)
    v_start: float = NAN          # virtual seconds (engine clock)
    v_end: float = NAN
    wall_start: float = NAN       # host seconds since tracer start
    wall_end: float = NAN
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def v_dur(self) -> float:
        return self.v_end - self.v_start

    @property
    def has_virtual(self) -> bool:
        return math.isfinite(self.v_start) and math.isfinite(self.v_end)

    @property
    def has_wall(self) -> bool:
        return math.isfinite(self.wall_start) and math.isfinite(self.wall_end)


class Tracer:
    """Append-only span log with explicit parents and a wall-span stack.

    Two recording styles, matching how the engine knows about time:

      * :meth:`record` — a span whose VIRTUAL interval is already priced
        (the engine computes a client's download/compute/uplink times when
        it schedules the client, not as they "happen"); parent defaults to
        the innermost open wall span so retroactive virtual spans still
        nest under the host phase that produced them.
      * :meth:`span` — a context manager that measures the WALL interval
        of the enclosed host work (``program.run``, codec round-trips, kernel
        builds) and maintains the nesting stack.

    ``set_virtual_offset`` re-bases subsequent virtual times: the trainer
    calls it when it rebuilds the engine (whose virtual clock restarts at
    0) so one recording's virtual timeline stays monotone across rebuilds.
    """

    def __init__(self, run_id: str = "run"):
        self.run_id = run_id
        self.spans: List[Span] = []
        self._stack: List[int] = []
        self._next_id = 0
        self._wall0 = time.perf_counter()
        self._v_offset = 0.0

    # ------------------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._wall0

    def set_virtual_offset(self, offset_s: float) -> None:
        self._v_offset = float(offset_s)

    @property
    def virtual_offset(self) -> float:
        return self._v_offset

    def last_virtual_end(self) -> float:
        """Latest virtual end across all spans (0.0 when none) — what the
        trainer re-bases a fresh engine's clock to."""
        ends = [s.v_end for s in self.spans if s.has_virtual]
        return max(ends) if ends else 0.0

    # ------------------------------------------------------------------
    def record(self, name: str, *, cat: str, track: str,
               v_start: float, v_end: float,
               parent: Optional[int] = None,
               args: Optional[Dict[str, Any]] = None,
               wall_start: float = NAN, wall_end: float = NAN) -> int:
        """Append a virtually-timed span; returns its id (for children)."""
        if parent is None and self._stack:
            parent = self._stack[-1]
        sid = self._next_id
        self._next_id += 1
        self.spans.append(Span(
            sid, parent, name, cat, track,
            v_start=self._v_offset + float(v_start),
            v_end=self._v_offset + float(v_end),
            wall_start=wall_start, wall_end=wall_end,
            args=dict(args or {})))
        return sid

    @contextmanager
    def span(self, name: str, *, cat: str = "host", track: str = "host",
             args: Optional[Dict[str, Any]] = None) -> Iterator[int]:
        """Wall-clocked span around host work; nests via the stack."""
        parent = self._stack[-1] if self._stack else None
        sid = self._next_id
        self._next_id += 1
        self._stack.append(sid)
        t0 = self._now()
        try:
            yield sid
        finally:
            self._stack.pop()
            self.spans.append(Span(
                sid, parent, name, cat, track,
                wall_start=t0, wall_end=self._now(),
                args=dict(args or {})))

    # ------------------------------------------------------------------
    def children(self, span_id: Optional[int]) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span_id]

    def by_cat(self, cat: str) -> List[Span]:
        return [s for s in self.spans if s.cat == cat]

    def by_id(self, span_id: int) -> Span:
        for s in self.spans:
            if s.span_id == span_id:
                return s
        raise KeyError(span_id)

    # ------------------------------------------------------------------
    def to_chrome(self, clock: str = "virtual") -> Dict[str, Any]:
        """Chrome-trace object: X events in microseconds, pid per clock."""
        if clock not in TRACE_CLOCKS:
            raise ValueError(f"clock={clock!r}; expected one of "
                             f"{list(TRACE_CLOCKS)}")
        tids: Dict[str, int] = {}

        def tid(track: str) -> int:
            if track not in tids:
                tids[track] = len(tids) + 1
            return tids[track]

        events: List[Dict[str, Any]] = []
        want_v = clock in ("virtual", "both")
        want_w = clock in ("wall", "both")
        for s in self.spans:
            # args must be JSON-finite: a trace with NaN breaks strict
            # Chrome-trace parsers, so non-finite values are stringified
            args = {k: (v if not isinstance(v, float) or math.isfinite(v)
                        else repr(v)) for k, v in s.args.items()}
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            if want_v and s.has_virtual:
                events.append({
                    "name": s.name, "cat": s.cat, "ph": "X",
                    "pid": PID_VIRTUAL, "tid": tid(s.track),
                    "ts": s.v_start * 1e6,
                    "dur": max(0.0, s.v_dur) * 1e6,
                    "args": args})
            if want_w and s.has_wall:
                events.append({
                    "name": s.name, "cat": s.cat, "ph": "X",
                    "pid": PID_WALL, "tid": tid(s.track),
                    "ts": s.wall_start * 1e6,
                    "dur": max(0.0, s.wall_end - s.wall_start) * 1e6,
                    "args": args})
        meta: List[Dict[str, Any]] = []
        for pid, pname, on in ((PID_VIRTUAL, "virtual clock", want_v),
                               (PID_WALL, "wall clock", want_w)):
            if not on:
                continue
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": pname}})
            for track, t in sorted(tids.items(), key=lambda kv: kv[1]):
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": t, "args": {"name": track}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"run_id": self.run_id, "clock": clock}}

    def export_chrome(self, path: str, clock: str = "virtual") -> str:
        obj = self.to_chrome(clock)
        validate_chrome_trace(obj)
        with open(path, "w") as f:
            # allow_nan=False: a file Perfetto rejects must fail HERE
            json.dump(obj, f, allow_nan=False)
        return path


def validate_chrome_trace(obj: Any) -> int:
    """Chrome-trace JSON-object-format schema check; returns the number of
    "X" complete events.  Raises ``ValueError`` on any violation — this is
    what CI runs against the exported file."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with a traceEvents list")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    n_complete = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"event {i} missing required key {k!r}")
        if not isinstance(ev["ph"], str) or len(ev["ph"]) != 1:
            raise ValueError(f"event {i}: ph must be a 1-char phase code")
        if ev["ph"] == "X":
            n_complete += 1
            for k in ("ts", "dur"):
                v = ev.get(k)
                if not isinstance(v, (int, float)) or not math.isfinite(v):
                    raise ValueError(
                        f"event {i}: X event needs finite numeric {k!r}")
            if ev["dur"] < 0:
                raise ValueError(f"event {i}: negative dur")
    if n_complete == 0:
        raise ValueError("trace contains no complete ('X') events")
    return n_complete
