"""Two-clock span tracing for the federated split engine, and the host
spans the program places where its work happens.  The virtual clock and the
Chrome export are a port of ``repro/obs/trace.py``.

The engine advances a *virtual* clock (the paper's analytic time model:
download + segment compute + LAN hops + uplink), while the tensor math runs
on the host in *wall* time.  A :class:`Span` therefore carries both clocks:
``v_start``/``v_end`` in virtual seconds (NaN when the span is wall-only)
and ``wall_start``/``wall_end`` in host seconds (NaN when the span was
placed retroactively from priced times — the engine knows a client's whole
virtual timeline the moment it schedules it, so most spans are recorded
with :meth:`Tracer.record` rather than timed live).

Wall time is the system clock (``time.time_ns()``), the clock a
``torch.profiler`` trace counts from (its ``baseTimeNanoseconds``):
``wall_start``/``wall_end`` are seconds from the tracer's ``wall0_ns``, and
the Chrome export gives wall events absolute timestamps (microseconds since
the epoch), so a profiler trace's events (``baseTimeNanoseconds`` + 1000 x
their ``ts``) lie on the same timeline.

The program's host spans come from the module-level :func:`span`: the
FSL-GAN round (``core/gan.py``, ``fed/engine.py``, ``fed/programs.py``) is
round > engine > client > sample / group > batch, with uplink and reduce
under engine and commit, g_update and feedback under round; the LM train
step (``runtime/train.py``) is step > microbatch / accumulate / optim, with
an ``mla`` span around each MLA attention call (``models/mla.py``) and a
``moe`` span around each MoE layer call (``models/moe.py``) inside a
micro-batch's forward.  Code that autograd's backward runs (a remat
recompute) opens no span, so these cover the forward passes alone.
They record only while :func:`tracing` makes a tracer the process's active
one; with none active, :func:`span` is one global read that returns a
shared no-op context.

The program's counters (:func:`count`; the MoE layer's token-slots) are
added up on the device while a tracer is active and read on the host in
one transfer when the outermost open span closes (a step), into
:attr:`Tracer.counters` by the span's index; the program computes them
only where :func:`counting` says so, so with no tracer they cost no
launch and no sync.  ``tracing(device_events=True)`` adds a CUDA event
pair on the current stream around each span (its device extent,
:meth:`Tracer.device_ms`); ``count_syncs=True`` charges each host-device
synchronisation to the innermost open span (``Span.syncs``), as PyTorch's
sync debug mode reports them.

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
import warnings
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

NAN = float("nan")

# Chrome-trace pids: one synthetic "process" per clock, so both timelines
# coexist in one file without colliding timestamps.
PID_VIRTUAL = 1
PID_WALL = 2

TRACE_CLOCKS = ("virtual", "wall", "both")

# what PyTorch's sync debug mode ("warn") says at each synchronising call
SYNC_WARNING = "called a synchronizing CUDA operation"


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
    wall_start: float = NAN       # host seconds from the tracer's wall0_ns
    wall_end: float = NAN
    args: Dict[str, Any] = field(default_factory=dict)
    index: Optional[int] = None   # the round or step a wall span belongs to
    syncs: int = 0                # host-device syncs charged to a wall span

    @property
    def v_dur(self) -> float:
        return self.v_end - self.v_start

    @property
    def has_virtual(self) -> bool:
        return math.isfinite(self.v_start) and math.isfinite(self.v_end)

    @property
    def has_wall(self) -> bool:
        return math.isfinite(self.wall_start) and math.isfinite(self.wall_end)


@dataclass
class _Open:
    """A wall span while it is open: what its children inherit and what
    is charged to it."""
    sid: int
    index: Optional[int]
    syncs: int = 0


class Tracer:
    """Append-only span log with explicit parents and a wall-span stack.

    Two recording styles, matching how the engine knows about time:

      * :meth:`record` — a span whose VIRTUAL interval is already priced
        (the engine computes a client's download/compute/uplink times when
        it schedules the client, not as they "happen"); parent defaults to
        the innermost open wall span so retroactive virtual spans still
        nest under the host phase that produced them.
      * :meth:`span` — a context manager that measures the WALL interval
        of the enclosed host work (the program's :func:`span` calls) and
        maintains the nesting stack.

    ``set_virtual_offset`` re-bases subsequent virtual times: the trainer
    calls it when it rebuilds the engine (whose virtual clock restarts at
    0) so one recording's virtual timeline stays monotone across rebuilds.
    """

    def __init__(self, run_id: str = "run"):
        self.run_id = run_id
        self.spans: List[Span] = []
        self._stack: List[_Open] = []
        self._next_id = 0
        self.wall0_ns = time.time_ns()
        self._v_offset = 0.0
        # host-device syncs made while no wall span was open
        self.syncs_outside = 0
        self._events: Dict[int, Tuple[Any, Any]] = {}
        self._device_ms: Dict[int, float] = {}
        # the program's counters (:func:`count`): added up on the device,
        # read on the host when an outermost span closes, by its index
        self._pending: Dict[str, Any] = {}
        self.counters: Dict[Optional[int], Dict[str, int]] = {}

    # ------------------------------------------------------------------
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
            parent = self._stack[-1].sid
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
             args: Optional[Dict[str, Any]] = None,
             index: Optional[int] = None,
             device_events: bool = False) -> Iterator[int]:
        """Wall-clocked span around host work; nests via the stack.
        ``index`` (the round or step) defaults to the enclosing span's;
        ``device_events`` records a CUDA event pair on the current stream
        around the work (:meth:`device_ms`)."""
        top = self._stack[-1] if self._stack else None
        if index is None and top is not None:
            index = top.index
        sid = self._next_id
        self._next_id += 1
        frame = _Open(sid, None if index is None else int(index))
        self._stack.append(frame)
        t0 = time.time_ns()
        start = _cuda_event() if device_events else None
        try:
            yield sid
        finally:
            if start is not None:
                self._events[sid] = (start, _cuda_event())
            t1 = time.time_ns()
            self._stack.pop()
            self.spans.append(Span(
                sid, top.sid if top is not None else None, name, cat, track,
                wall_start=(t0 - self.wall0_ns) / 1e9,
                wall_end=(t1 - self.wall0_ns) / 1e9,
                args=dict(args or {}), index=frame.index,
                syncs=frame.syncs))
            if not self._stack:
                self.flush_counters(frame.index)

    def add_count(self, name: str, value) -> None:
        """Add ``value`` (a device tensor, or a host number) to the
        counter ``name``; nothing is read on the host here."""
        have = self._pending.get(name)
        self._pending[name] = value if have is None else have + value

    def flush_counters(self, index: Optional[int] = None) -> None:
        """Read the counters added since the last read on the host, in
        one transfer, and add them to ``counters[index]``."""
        if not self._pending:
            return
        names = list(self._pending)
        vals = [self._pending[n] for n in names]
        dev = [i for i, v in enumerate(vals) if torch.is_tensor(v)]
        if dev:
            got = torch.stack([vals[i].to(torch.int64) for i in dev]
                              ).tolist()
            for i, g in zip(dev, got):
                vals[i] = g
        self._pending = {}
        into = self.counters.setdefault(index, {})
        for n, v in zip(names, vals):
            into[n] = into.get(n, 0) + int(v)

    def count_sync(self) -> None:
        """Charge one host-device synchronisation to the innermost open
        wall span (``syncs_outside`` when none is open)."""
        if self._stack:
            self._stack[-1].syncs += 1
        else:
            self.syncs_outside += 1

    def device_ms(self) -> Dict[int, float]:
        """Device extent in ms of each span recorded with device events,
        by span id: the time from the stream reaching the span's start to
        reaching its end.  Synchronises the device when an extent is not
        read yet."""
        if len(self._device_ms) < len(self._events):
            torch.cuda.synchronize()
            for sid, (a, b) in self._events.items():
                if sid not in self._device_ms:
                    self._device_ms[sid] = a.elapsed_time(b)
        return dict(self._device_ms)

    def wall_ns(self, s: Span) -> Tuple[int, int]:
        """A wall span's start and end on the system clock, in ns."""
        return (self.wall0_ns + round(s.wall_start * 1e9),
                self.wall0_ns + round(s.wall_end * 1e9))

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
                w0, w1 = self.wall_ns(s)
                wargs = dict(args, syncs=s.syncs)
                if s.index is not None:
                    wargs["index"] = s.index
                events.append({
                    "name": s.name, "cat": s.cat, "ph": "X",
                    "pid": PID_WALL, "tid": tid(s.track),
                    "ts": w0 / 1e3, "dur": max(0, w1 - w0) / 1e3,
                    "args": wargs})
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


def _cuda_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


# ---------------------------------------------------------------------------
# the process's active tracer: what the program's span() calls record into
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Active:
    tracer: Tracer
    device_events: bool


_ACTIVE: Optional[_Active] = None
_OFF = nullcontext()


def _in_backward() -> bool:
    """Whether autograd's backward is running this code: a checkpointed
    (remat) layer's forward recomputed for its gradient."""
    return torch._C._current_graph_task_id() != -1


def span(name: str, **args):
    """A wall span named ``name`` in the active tracer (:func:`tracing`):
    ``index=`` sets the round or step it belongs to (nested spans inherit
    it), other keywords become its args.  With no active tracer it returns
    a shared no-op context: no clock read, no CUDA event, no record.  Code
    that autograd's backward runs (a remat recompute, on the backward's
    own thread for CUDA tensors) opens no span either: spans cover the
    forward passes the program runs itself."""
    act = _ACTIVE
    if act is None or _in_backward():
        return _OFF
    index = args.pop("index", None)
    return act.tracer.span(name, args=args, index=index,
                           device_events=act.device_events)


def counting() -> bool:
    """Whether :func:`count` records: a tracer is active and the caller is
    not autograd's backward.  The program computes its counters only
    then, so with tracing off they cost no launch and no sync."""
    return _ACTIVE is not None and not _in_backward()


def count(**values) -> None:
    """Add each keyword's value (a device tensor or a host number) to the
    active tracer's counter of that name (:meth:`Tracer.add_count`); read
    on the host once, when the outermost open span closes."""
    if not counting():
        return
    for name, v in values.items():
        _ACTIVE.tracer.add_count(name, v)


@contextmanager
def tracing(tracer: Tracer, *, device_events: bool = False,
            count_syncs: bool = False) -> Iterator[Tracer]:
    """Make ``tracer`` the process's active tracer for the block, so the
    program's :func:`span` calls record into it (the previous one, if any,
    is active again after).  ``device_events`` gives each span a CUDA event
    pair (the program must run on the card); ``count_syncs`` charges each
    host-device synchronisation to the innermost open span.  Not for
    concurrent use from several threads."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = _Active(tracer, bool(device_events))
    try:
        with _counting_syncs(tracer) if count_syncs else nullcontext():
            yield tracer
    finally:
        _ACTIVE = prev


@contextmanager
def _counting_syncs(tracer: Tracer) -> Iterator[None]:
    """PyTorch's sync debug mode set to ``warn`` for the block, and its
    warnings counted on ``tracer`` instead of shown: it warns at every
    call that waits for the device (``item``, ``tolist``, ``nonzero``, a
    blocking copy either way), though not at an explicit
    ``torch.cuda.synchronize`` (the round makes one only in the ``auto``
    backend's probe).  The mode is left alone where it cannot be set: a
    build without CUDA, or CUDA not initialised yet (setting it would
    initialise CUDA)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING)
        # said once when the mode is set
        warnings.filterwarnings("ignore", message="Synchronization debug mode")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if str(message).startswith(SYNC_WARNING):
                tracer.count_sync()
            else:
                shown(message, category, filename, lineno, file, line)
        warnings.showwarning = show
        mode = None
        if hasattr(torch._C, "_cuda_get_sync_debug_mode") \
                and torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)


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
