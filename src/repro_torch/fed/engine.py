"""Discrete-event federation round engine.  Port of ``repro/fed/engine.py``.

Each round, every available client

  1. downloads the server's fake batches      (downlink, LinkModel-priced),
  2. runs local discriminator training       (compute, priced by the
     paper's analytic model ``core/simulate.plan_epoch_time``),
  3. uplinks its discriminator through the codec (``fed/transport``) —
     lossy codecs compress the delta vs the downloaded tree, after the
     optional pre-codec ``uplink_stage`` (uplink DP) privatized it — and
  4. the server aggregates per its policy     (``fed/policies``).

Two scheduling modes:

  * **sync** — a barrier with batched dispatch: all clients that can
    possibly meet the deadline are handed to the program as ONE ``run``
    call (a roster-order loop, host-RNG identical to the sequential
    trainer).  A ``deadline_s`` drops straggler updates whose virtual
    finish time exceeds it; their download, LAN and compute are still
    counted.  With ``fed.hierarchy_cohorts >= 2`` clients uplink over the
    edge link to their cohort's edge, which pre-reduces, and one tree per
    cohort crosses the WAN (``fed/hierarchy``).
  * **async (fedasync | fedbuff)** — a FINISH/ARRIVE event queue: a
    client's local round executes when its compute finishes, on the global
    snapshot it downloaded; the update lands after its uplink delay, and
    staleness counts the global versions advanced in between.  Clients
    cycle ``async_cycles`` times a round.

The server reduce (``fed.server_reduce``): ``decode`` decodes every uplink
and hands the trees to the policy (the bit-exact reference);
``stream`` and ``batched`` reduce the WIRE payloads in the compressed
domain (``fed/aggregate``, the agg_fuse kernels under
``fed.kernel_aggregation``), one accumulator tree at a time.  Async always
decodes per arrival, but under ``stream``/``batched`` its ARRIVE queue
carries wire payloads instead of decoded trees.

Only updates that land commit their optimizer state
(``RoundReport.opt_states``).  The clock the engine advances is *virtual*
(the paper's Fig-2 time model extended with WAN transfers); the tensor math
runs on whatever device holds the parameters.

The control plane retunes the engine between rounds (:meth:`set_codec`,
:meth:`set_deadline`).  Observability hooks in without touching the
numbers: an attached tracer (:meth:`set_tracer`) receives virtual-clock
spans of each round (round -> download -> client execution -> split
batch/segment/boundary -> uplink -> aggregate), a digester
(:meth:`set_digester`) stamps ``RoundReport.global_digest``, and the
ledger's observers see every byte it records.  With none attached,
scheduling and numerics are the same.

Host spans (``repro_torch/obs/trace.py``, recorded under an active
tracer): ``engine`` is one :meth:`FederationEngine.run_round`; inside it
the client program's ``client``, one ``uplink`` a client (the encode and,
where it is measured apart from the fold, the codec error) and ``reduce``
for the server reduce (the stream accumulator and its folds, the staged
decode and FedAvg, the batched reduce, the edge pre-reduce).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.fed.aggregate import (StreamingAggregator, batched_reduce,
                                      codec_rel_error, decode_enc,
                                      fused_decode_apply)
from repro_torch.fed.events import (ARRIVE, FINISH, EventQueue,
                                   make_availability)
from repro_torch.fed.hierarchy import HierarchicalAggregator
from repro_torch.fed.policies import ClientUpdate, make_policy
from repro_torch.fed.programs import as_program
from repro_torch.fed.transport import (LinkModel, TrafficLedger, apply_delta,
                                      delta_tree, make_codec, tree_bytes,
                                      tree_rel_error)
from repro_torch.obs.trace import span


@dataclass(frozen=True)
class ClientSpec:
    """Static per-client facts the scheduler needs."""
    client_id: str
    weight: float                 # FedAvg weight (example count)
    compute_time_s: float         # one local round (core/simulate)
    lr_scale: float = 1.0         # per-client LR schedule (cfg.fed)
    local_steps: int = 0          # per-client round length (0 = default)


@dataclass
class RoundReport:
    global_params: Any
    participated: List[str] = field(default_factory=list)
    unavailable: List[str] = field(default_factory=list)
    stragglers: List[str] = field(default_factory=list)
    round_time_s: float = 0.0
    clock_s: float = 0.0          # engine clock after this round
    traffic: TrafficLedger = field(default_factory=TrafficLedger)
    client_infos: List[Tuple[str, Dict[str, Any]]] = field(
        default_factory=list)            # in execution order
    staleness: Dict[str, int] = field(default_factory=dict)   # last per client
    staleness_events: List[int] = field(default_factory=list)  # every arrival
    version: int = 0
    # final opt state per client whose update landed (participated) —
    # the caller commits exactly these; dropped work leaves no state
    opt_states: Dict[str, Any] = field(default_factory=dict)
    # per-client virtual finish times (download + compute + uplink);
    # provably-late stragglers that never ran record download + compute
    finish_s: Dict[str, float] = field(default_factory=dict)
    # relative L2 error the codec cost each executed client's (possibly
    # privatized) delta (0.0 under the identity codec)
    codec_error: Dict[str, float] = field(default_factory=dict)
    # content digest of the as-aggregated global_params, stamped by the
    # engine's digester hook (set_digester) the moment aggregation lands —
    # BEFORE any health action touches the tree, so a rolled-back round
    # still records what the aggregate actually was
    global_digest: Optional[str] = None
    # peak count of decoded fp32 update trees live at the server during
    # aggregation: the decode reduce stages one per landed client (O(C)),
    # the compressed-domain reduce only its accumulator (O(1))
    peak_live_trees: int = 0

    @property
    def mean_staleness(self) -> float:
        if not self.staleness_events:
            return 0.0
        return sum(self.staleness_events) / len(self.staleness_events)


class FederationEngine:
    def __init__(self, fed_cfg, specs: List[ClientSpec], *,
                 weighted: bool = True, uplink_stage=None, cohort_of=None):
        self.cfg = fed_cfg
        self.roster = [s.client_id for s in specs]
        self.specs = {s.client_id: s for s in specs}
        self.weighted = bool(weighted)
        self.policy = make_policy(fed_cfg, weighted=weighted)
        # server reduce (config.SERVER_REDUCES): "decode" stages decoded
        # trees through the policy; "stream"/"batched" reduce wire payloads
        # in the compressed domain on the sync paths.  Async decodes per
        # arrival either way, but its ARRIVE queue then carries wires.
        self.server_reduce = fed_cfg.server_reduce
        # pre-codec uplink transform (privacy/defenses.DPUplinkStage): runs
        # on the update delta BEFORE compression, so the codec and the
        # server only ever see the privatized delta.  None: no transform.
        self.uplink_stage = uplink_stage
        self.codec_name = fed_cfg.codec
        self.topk_frac = fed_cfg.topk_frac
        self.codecs = {cid: make_codec(fed_cfg.codec,
                                       topk_frac=fed_cfg.topk_frac,
                                       error_feedback=fed_cfg.error_feedback)
                       for cid in self.roster}
        # the live straggler deadline: seeded from config, retuned between
        # rounds by the control plane (set_deadline) without touching cfg
        self.deadline_s = float(fed_cfg.deadline_s)
        self.uplink = LinkModel(fed_cfg.wan_latency_s, fed_cfg.uplink_bps)
        self.downlink = LinkModel(fed_cfg.wan_latency_s, fed_cfg.downlink_bps)
        # two-tier edge aggregation (fed/hierarchy): cohorts >= 2 on the
        # sync path sends client updates over the edge link, pre-reduces
        # per cohort and uplinks ONE tree per cohort across the WAN
        self.edge_link = LinkModel(fed_cfg.edge_latency_s,
                                   fed_cfg.edge_uplink_bps)
        self.hierarchy: Optional[HierarchicalAggregator] = None
        if fed_cfg.hierarchy_cohorts >= 2 and fed_cfg.mode == "sync":
            self.hierarchy = HierarchicalAggregator(
                fed_cfg.hierarchy_cohorts,
                use_kernel=fed_cfg.kernel_aggregation, cohort_of=cohort_of)
        self.availability = make_availability(fed_cfg.availability,
                                              fed_cfg.availability_seed)
        self.clock = 0.0
        self.round_idx = 0
        self.version = 0
        self.ledger = TrafficLedger()      # cumulative across rounds
        self._lan_by: Dict[str, int] = {}  # this round's LAN bytes/client
        self.last_report: Optional[RoundReport] = None
        # client mesh of the "batched" reduce (set_mesh); None: one device
        self.mesh = None
        # observability: an optional tracer and per-client split
        # timelines; None/empty emits no spans
        self.tracer = None
        self._trace_batch_cap = 0
        self._timelines: Dict[str, Any] = {}
        # optional content-digest hook (obs.digest.tree_digest): stamps
        # RoundReport.global_digest on the as-aggregated tree
        self._digester = None

    def set_codec(self, name: str, topk_frac: Optional[float] = None) -> None:
        """Swap the uplink codec for subsequent rounds (codec controller).
        Rebuilds the per-client codecs, which clears any top-k error-
        feedback residual: the residual belongs to the OLD codec's lossy
        stream and must not be replayed into the new one."""
        frac = self.topk_frac if topk_frac is None else float(topk_frac)
        if name == self.codec_name and frac == self.topk_frac:
            return
        self.codec_name, self.topk_frac = name, frac
        self.codecs = {cid: make_codec(name, topk_frac=frac,
                                       error_feedback=self.cfg.error_feedback)
                       for cid in self.roster}

    def set_deadline(self, deadline_s: float) -> None:
        """Retune the sync straggler deadline (deadline controller)."""
        self.deadline_s = float(deadline_s)

    def set_tracer(self, tracer, *, batch_cap: int = 0) -> None:
        """Attach a :class:`repro_torch.obs.Tracer`; subsequent rounds emit
        virtual-clock spans.  ``batch_cap`` bounds how many batches per
        client get per-phase split spans (0 = all).  None detaches."""
        self.tracer = tracer
        self._trace_batch_cap = int(batch_cap)

    def set_digester(self, fn) -> None:
        """Attach a content-digest function ``tree -> str``
        (:func:`repro_torch.obs.digest.tree_digest`); each subsequent round
        stamps ``RoundReport.global_digest`` with the digest of the
        as-aggregated global tree.  None detaches."""
        self._digester = fn

    def set_mesh(self, mesh) -> None:
        """Attach a client mesh (``launch/mesh.Mesh``) for the "batched"
        server reduce: each device reduces its chunk of the round's wires
        (``fed/aggregate.batched_reduce``).  None restores the one-device
        reduce."""
        self.mesh = mesh

    # ------------------------------------------------------------------
    def _codec_roundtrip(self, cid: str, base_tree, params
                         ) -> Tuple[Any, int, float]:
        """Uplink params through the client's codec; lossy codecs compress
        the delta vs the tree the client downloaded (``base_tree``).  An
        ``uplink_stage`` runs on the delta first.  Returns ``(decoded,
        wire_bytes, rel_error)``, ``rel_error`` being the relative L2 error
        the codec cost the (possibly privatized) delta."""
        codec = self.codecs[cid]
        if codec.encodes_delta or self.uplink_stage is not None:
            delta = delta_tree(params, base_tree)
            if self.uplink_stage is not None:
                delta = self.uplink_stage(cid, delta)
            dec, nbytes = codec.roundtrip(delta)
            err = tree_rel_error(dec, delta) if codec.encodes_delta else 0.0
            return apply_delta(base_tree, dec), nbytes, err
        dec, nbytes = codec.roundtrip(params)
        return dec, nbytes, 0.0

    def _encode_uplink(self, cid: str, base_tree, params
                       ) -> Tuple[Any, int, Any, bool]:
        """Wire-level form of :meth:`_codec_roundtrip`: encode the uplink
        WITHOUT decoding it.  Returns ``(enc, wire_bytes, delta,
        is_delta)``: ``enc`` the ``Codec.encode_tree`` payload, ``delta``
        the raw (possibly privatized) delta for the error measurement (None
        for a lossless codec), ``is_delta`` whether the wire is in the
        delta domain.  Prices the same bytes, applies the same
        ``uplink_stage`` and advances codec residuals as the decode path
        does."""
        codec = self.codecs[cid]
        if codec.encodes_delta or self.uplink_stage is not None:
            delta = delta_tree(params, base_tree)
            if self.uplink_stage is not None:
                delta = self.uplink_stage(cid, delta)
            enc, nbytes = codec.encode_tree(delta)
            return (enc, nbytes,
                    delta if codec.encodes_delta else None, True)
        enc, nbytes = codec.encode_tree(params)
        return enc, nbytes, None, False

    def _weight(self, cid: str) -> float:
        return self.specs[cid].weight if self.weighted else 1.0

    def _split_roster(self) -> Tuple[List[str], List[str]]:
        up, down = [], []
        for cid in self.roster:
            (up if self.availability.available(cid, self.round_idx)
             else down).append(cid)
        return up, down

    # ------------------------------------------------------------------
    def run_round(self, global_tree, program, *, down_bytes: int = 0,
                  down_bytes_by_client: Optional[Dict[str, int]] = None,
                  lan_bytes_by_client: Optional[Dict[str, int]] = None,
                  timeline_by_client: Optional[Dict[str, Any]] = None
                  ) -> RoundReport:
        """One FL round.  ``program``: a client program (``fed/programs``)
        or a bare callable.  ``down_bytes``: server->client fake payload;
        ``down_bytes_by_client`` overrides it per client (clients on a
        longer ``local_steps`` schedule download more fake batches).
        ``lan_bytes_by_client``: split-boundary bytes of one local round,
        recorded per *execution*, straggler or not.
        ``timeline_by_client``: one batch's ordered split phases per client
        (``core/split.SplitExecution.round_timeline``), read only when a
        tracer is attached, to subdivide client-execution spans."""
        program = as_program(program)
        with span("engine"):
            down_by = dict(down_bytes_by_client or {})
            db = lambda cid: down_by.get(cid, down_bytes)  # noqa: E731
            self._lan_by = dict(lan_bytes_by_client or {})
            self._timelines = dict(timeline_by_client or {})
            if self.cfg.mode != "sync":
                rep = self._run_async(global_tree, program, db)
            elif self.hierarchy is not None:
                rep = self._run_sync_hier(global_tree, program, db)
            else:
                rep = self._run_sync(global_tree, program, db)
            self.round_idx += 1
            if self._digester is not None:
                rep.global_digest = self._digester(rep.global_params)
            for cid in rep.traffic.up_bytes:
                self.ledger.record(cid, up=rep.traffic.up_bytes[cid])
            for cid in rep.traffic.down_bytes:
                self.ledger.record(cid, down=rep.traffic.down_bytes[cid])
            for cid in rep.traffic.lan_bytes:
                self.ledger.record(cid, lan=rep.traffic.lan_bytes[cid])
            for cid in rep.traffic.edge_bytes:
                self.ledger.record_edge(cid, rep.traffic.edge_bytes[cid])
            self.last_report = rep
        return rep

    def _run_clients(self, rep: RoundReport, global_tree, program, db,
                     down_t: Dict[str, float]):
        """Sync dispatch: every client that can possibly meet the deadline
        executes in ONE ``program.run`` call; provably-late clients never
        run (no work and no host RNG spent on them) and are recorded as
        stragglers with their known lower-bound finish."""
        deadline = self.deadline_s
        runnable: List[str] = []
        for cid in down_t:
            if deadline and down_t[cid] + self.specs[cid].compute_time_s \
                    > deadline:
                rep.stragglers.append(cid)
                rep.traffic.record(cid, down=db(cid))
                rep.finish_s[cid] = (down_t[cid]
                                     + self.specs[cid].compute_time_s)
            else:
                runnable.append(cid)
        return program.run(runnable, global_tree)

    def _land(self, rep: RoundReport, cid: str, opt_state) -> None:
        """Book a landed sync update (staleness 0)."""
        rep.participated.append(cid)
        if opt_state is not None:
            rep.opt_states[cid] = opt_state
        rep.staleness[cid] = 0
        rep.staleness_events.append(0)

    def _close_round(self, rep: RoundReport, new_global,
                     finishes: List[float]) -> RoundReport:
        """The sync barrier releases at the slowest survivor, or at the
        deadline when stragglers were waited out that long."""
        if rep.participated:
            self.version += 1
        rep.round_time_s = max(finishes) if finishes else 0.0
        if self.deadline_s and rep.stragglers:
            rep.round_time_s = max(rep.round_time_s, self.deadline_s)
        self.clock += rep.round_time_s
        rep.clock_s = self.clock
        rep.global_params = new_global
        rep.version = self.version
        return rep

    # ------------------------------------------------------------------
    # span emission (repro_torch.obs).  Spans are recorded retroactively from
    # the round's priced times once they are all known — the discrete-
    # event engine schedules whole client windows, it never "waits".
    # ------------------------------------------------------------------
    def _emit_exec_span(self, tr, parent, cid: str, start: float,
                        compute_dur: float, args: Dict[str, Any]) -> int:
        """Client-execution span [start, start+compute_dur], subdivided
        into per-batch split-segment / boundary-crossing phases when a
        timeline is known for this client."""
        sid = tr.record(f"exec {cid}", cat="client", track=cid,
                        v_start=start, v_end=start + compute_dur,
                        parent=parent, args=args)
        tl = self._timelines.get(cid)
        if not tl:
            return sid
        phases, batch_time = tl
        if batch_time <= 0.0 or not phases:
            return sid
        steps = self.specs[cid].local_steps \
            or max(1, int(round(compute_dur / batch_time)))
        n = steps if self._trace_batch_cap <= 0 \
            else min(steps, self._trace_batch_cap)
        for b in range(n):
            off = start + b * batch_time
            bid = tr.record(f"batch {b}", cat="batch", track=cid,
                            v_start=off, v_end=off + batch_time, parent=sid)
            for ph in phases:
                tr.record(ph["name"], cat=ph["cat"], track=ph["track"],
                          v_start=off + ph["t0"], v_end=off + ph["t1"],
                          parent=bid, args=ph["args"])
        return sid

    def _emit_sync_spans(self, rep: RoundReport, t0: float,
                         down_t: Dict[str, float]) -> None:
        tr = self.tracer
        rnd = tr.record(
            f"round {self.round_idx}", cat="round", track="server",
            v_start=t0, v_end=t0 + rep.round_time_s,
            args={"mode": "sync", "participated": len(rep.participated),
                  "stragglers": len(rep.stragglers),
                  "codec": self.codec_name, "deadline_s": self.deadline_s})
        for cid, dt in down_t.items():
            spec = self.specs[cid]
            tr.record(f"down {cid}", cat="downlink", track=cid,
                      v_start=t0, v_end=t0 + dt, parent=rnd,
                      args={"bytes": rep.traffic.down_bytes.get(cid, 0)})
            args: Dict[str, Any] = {}
            if cid in rep.stragglers:
                args["dropped"] = True
            # ran iff the codec round-tripped its update this round
            if cid not in rep.codec_error:
                args["executed"] = False   # provably-late lower bound
                self._emit_exec_span(tr, rnd, cid, t0 + dt,
                                     spec.compute_time_s, args)
                continue
            self._emit_exec_span(tr, rnd, cid, t0 + dt,
                                 spec.compute_time_s, args)
            fin = rep.finish_s[cid]
            up_dur = max(0.0, fin - dt - spec.compute_time_s)
            tr.record(f"up {cid}", cat="uplink", track=cid,
                      v_start=t0 + fin - up_dur, v_end=t0 + fin, parent=rnd,
                      args={"bytes": rep.traffic.up_bytes.get(cid, 0),
                            "codec": self.codec_name,
                            "landed": cid in rep.participated})
        tr.record("aggregate", cat="aggregate", track="server",
                  v_start=t0 + rep.round_time_s, v_end=t0 + rep.round_time_s,
                  parent=rnd,
                  args={"num_updates": len(rep.participated),
                        "version": rep.version})

    def _emit_async_spans(self, rep: RoundReport, t0: float, last_t: float,
                          events: List[Dict[str, Any]]) -> None:
        tr = self.tracer
        rnd = tr.record(
            f"round {self.round_idx}", cat="round", track="server",
            v_start=t0, v_end=last_t,
            args={"mode": self.cfg.mode,
                  "participated": len(rep.participated),
                  "stragglers": len(rep.stragglers),
                  "codec": self.codec_name})
        for ev in events:
            cid = ev.get("cid", "")
            if ev["kind"] == "down":
                tr.record(f"down {cid}", cat="downlink", track=cid,
                          v_start=ev["t0"], v_end=ev["t1"], parent=rnd,
                          args={"bytes": ev["bytes"],
                                "cycle": ev["cycle"]})
            elif ev["kind"] == "exec":
                self._emit_exec_span(tr, rnd, cid, ev["t0"],
                                     ev["t1"] - ev["t0"],
                                     {"cycle": ev["cycle"]})
            elif ev["kind"] == "up":
                tr.record(f"up {cid}", cat="uplink", track=cid,
                          v_start=ev["t0"], v_end=ev["t1"], parent=rnd,
                          args={"bytes": ev["bytes"],
                                "codec": self.codec_name})
            else:                          # arrive -> server-side apply
                tr.record(f"aggregate {cid}", cat="aggregate",
                          track="server", v_start=ev["t"], v_end=ev["t"],
                          parent=rnd,
                          args={"staleness": ev["staleness"],
                                "landed": ev["landed"]})

    def _emit_hier_spans(self, rep: RoundReport, t0: float,
                         down_t: Dict[str, float],
                         cohort_trace: List[Dict[str, Any]]) -> None:
        """Round span -> per-client down/exec/edge-up spans -> one cohort
        span per edge (cat="cohort": pre-reduce ready time to WAN
        arrival) -> aggregate."""
        tr = self.tracer
        rnd = tr.record(
            f"round {self.round_idx}", cat="round", track="server",
            v_start=t0, v_end=t0 + rep.round_time_s,
            args={"mode": "sync", "hierarchy": True,
                  "cohorts": len(cohort_trace),
                  "participated": len(rep.participated),
                  "stragglers": len(rep.stragglers),
                  "codec": self.codec_name, "deadline_s": self.deadline_s})
        for cid, dt in down_t.items():
            spec = self.specs[cid]
            tr.record(f"down {cid}", cat="downlink", track=cid,
                      v_start=t0, v_end=t0 + dt, parent=rnd,
                      args={"bytes": rep.traffic.down_bytes.get(cid, 0)})
            args: Dict[str, Any] = {}
            if cid in rep.stragglers:
                args["dropped"] = True
            if cid not in rep.codec_error:
                args["executed"] = False
                self._emit_exec_span(tr, rnd, cid, t0 + dt,
                                     spec.compute_time_s, args)
                continue
            self._emit_exec_span(tr, rnd, cid, t0 + dt,
                                 spec.compute_time_s, args)
            fin = rep.finish_s[cid]
            up_dur = max(0.0, fin - dt - spec.compute_time_s)
            tr.record(f"edge-up {cid}", cat="uplink", track=cid,
                      v_start=t0 + fin - up_dur, v_end=t0 + fin, parent=rnd,
                      args={"bytes": rep.traffic.edge_bytes.get(cid, 0),
                            "tier": "edge", "codec": self.codec_name,
                            "landed": cid in rep.participated})
        for ct in cohort_trace:
            tr.record(f"cohort {ct['cohort']}", cat="cohort",
                      track=f"edge{ct['cohort']}",
                      v_start=t0 + ct["ready"], v_end=t0 + ct["finish"],
                      parent=rnd,
                      args={"members": len(ct["members"]),
                            "wan_bytes": ct["bytes"]})
        tr.record("aggregate", cat="aggregate", track="server",
                  v_start=t0 + rep.round_time_s, v_end=t0 + rep.round_time_s,
                  parent=rnd,
                  args={"num_updates": len(cohort_trace),
                        "version": rep.version})

    # ------------------------------------------------------------------
    def _run_sync(self, global_tree, program, db) -> RoundReport:
        rep = RoundReport(global_params=global_tree)
        participants, rep.unavailable = self._split_roster()
        t0 = self.clock
        deadline = self.deadline_s
        down_t = {cid: self.downlink.transfer_time(db(cid))
                  for cid in participants}
        finishes: List[float] = []
        results = self._run_clients(rep, global_tree, program, db, down_t)

        # compressed-domain reduce ("stream"/"batched"): landed uplinks
        # fold as WIRE payloads; no per-client decoded tree is staged
        reduce_mode = self.server_reduce
        agg: Optional[StreamingAggregator] = None
        staged: List[Tuple[Any, float]] = []      # batched: (enc, weight)
        is_delta = False
        if reduce_mode == "stream":
            with span("reduce"):
                agg = StreamingAggregator(
                    self.codec_name, use_kernel=self.cfg.kernel_aggregation)
                agg.init(global_tree)

        for res in results:
            cid = res.client_id
            spec = self.specs[cid]
            with span("uplink", client=cid):
                if reduce_mode == "decode":
                    decoded, up_b, cerr = self._codec_roundtrip(
                        cid, global_tree, res.params)
                else:
                    enc, up_b, delta, is_delta = self._encode_uplink(
                        cid, global_tree, res.params)
            finish = down_t[cid] + spec.compute_time_s \
                + self.uplink.transfer_time(up_b)
            rep.traffic.record(cid, up=up_b, down=db(cid),
                               lan=self._lan_by.get(cid, 0))
            rep.client_infos.append((cid, res.info))
            rep.finish_s[cid] = finish
            if reduce_mode == "decode":
                rep.codec_error[cid] = cerr
            if deadline and finish > deadline:
                if reduce_mode != "decode":
                    # ran but never folds: the codec's cost without
                    # decoding the dropped update
                    with span("uplink", client=cid):
                        rep.codec_error[cid] = codec_rel_error(
                            self.codec_name, enc, delta)
                rep.stragglers.append(cid)     # ran, but its update is late
                continue                       # nothing commits — not even
                                               # its optimizer state
            self._land(rep, cid, res.opt_state)
            finishes.append(finish)
            if reduce_mode == "stream":
                # fold now; the error rides the same sweep
                with span("reduce"):
                    err = agg.fold(enc, self._weight(cid), delta=delta)
                rep.codec_error[cid] = 0.0 if err is None else err
            elif reduce_mode == "batched":
                staged.append((enc, self._weight(cid)))
                with span("uplink", client=cid):
                    rep.codec_error[cid] = codec_rel_error(
                        self.codec_name, enc, delta)
            else:
                with span("reduce"):
                    self.policy.on_update(
                        global_tree, ClientUpdate(cid, decoded, spec.weight,
                                                  0, self.clock + finish))

        with span("reduce"):
            if reduce_mode == "decode":
                new_global = self.policy.on_round_end(global_tree)
                rep.peak_live_trees = len(rep.participated)
            else:
                if reduce_mode == "stream":
                    mean = agg.finalize()
                elif staged:
                    mean = batched_reduce(
                        self.codec_name, [e for e, _ in staged],
                        [w for _, w in staged], global_tree,
                        use_kernel=self.cfg.kernel_aggregation, mesh=self.mesh)
                else:
                    mean = None
                if mean is None:
                    new_global = global_tree
                else:
                    new_global = apply_delta(global_tree, mean) if is_delta \
                        else mean
                rep.peak_live_trees = 1 if rep.participated else 0
        self._close_round(rep, new_global, finishes)
        if self.tracer is not None:
            self._emit_sync_spans(rep, t0, down_t)
        return rep

    # ------------------------------------------------------------------
    def _run_sync_hier(self, global_tree, program, db) -> RoundReport:
        """Sync round through the two-tier edge hierarchy.

        Client updates travel the edge link (``edge_bytes``); each cohort's
        edge pre-reduces its members' updates with the weighted FedAvg the
        server applies, and ONE aggregate per cohort crosses the WAN
        (``up_bytes`` keyed ``cohort<k>``).  The weighted mean of weighted
        means equals the flat aggregate up to float reassociation.  A
        cohort is ready at its slowest surviving member; the round ends at
        the slowest cohort's WAN arrival."""
        rep = RoundReport(global_params=global_tree)
        participants, rep.unavailable = self._split_roster()
        t0 = self.clock
        deadline = self.deadline_s
        down_t = {cid: self.downlink.transfer_time(db(cid))
                  for cid in participants}
        results = self._run_clients(rep, global_tree, program, db, down_t)

        # per client: codec over the EDGE hop, deadline at edge arrival.
        # Under the compressed-domain reduce the edge stages WIRE payloads
        # and each cohort folds them through one streaming accumulator.
        reduce_mode = self.server_reduce
        is_delta = False
        landed: Dict[str, Tuple[Any, float]] = {}   # cid -> (payload, w)
        edge_finish: Dict[str, float] = {}
        for res in results:
            cid = res.client_id
            spec = self.specs[cid]
            with span("uplink", client=cid):
                if reduce_mode == "decode":
                    payload, up_b, cerr = self._codec_roundtrip(
                        cid, global_tree, res.params)
                else:
                    payload, up_b, delta, is_delta = self._encode_uplink(
                        cid, global_tree, res.params)
                    cerr = codec_rel_error(self.codec_name, payload, delta)
            finish = down_t[cid] + spec.compute_time_s \
                + self.edge_link.transfer_time(up_b)
            rep.traffic.record(cid, down=db(cid),
                               lan=self._lan_by.get(cid, 0))
            rep.traffic.record_edge(cid, up_b)
            rep.client_infos.append((cid, res.info))
            rep.finish_s[cid] = finish
            rep.codec_error[cid] = cerr
            if deadline and finish > deadline:
                rep.stragglers.append(cid)
                continue
            self._land(rep, cid, res.opt_state)
            landed[cid] = (payload, spec.weight)
            edge_finish[cid] = finish

        with span("reduce"):
            # per cohort: edge pre-reduce, then ONE WAN uplink per cohort
            if reduce_mode == "decode":
                reductions = self.hierarchy.reduce_all(landed)
            else:
                reductions = self.hierarchy.reduce_all_streaming(
                    landed, global_tree, codec_name=self.codec_name)
            cohort_finishes: List[float] = []
            cohort_trace: List[Dict[str, Any]] = []
            for red in reductions:
                aggregate = red.aggregate
                if reduce_mode != "decode" and is_delta:
                    # the stream reduce yields the cohort's mean DELTA; rebase
                    # it so the WAN payload is the full tree the decode path
                    # ships
                    aggregate = apply_delta(global_tree, aggregate)
                wan_b = tree_bytes(aggregate)
                ready = max(edge_finish[m] for m in red.members)
                finish = ready + self.uplink.transfer_time(wan_b)
                ckey = f"cohort{red.cohort}"
                rep.traffic.record(ckey, up=wan_b)
                cohort_finishes.append(finish)
                cohort_trace.append({"cohort": red.cohort, "ready": ready,
                                     "finish": finish, "bytes": wan_b,
                                     "members": list(red.members)})
                self.policy.on_update(
                    global_tree, ClientUpdate(ckey, aggregate, red.weight,
                                              0, self.clock + finish))
            # decode: every landed member tree and the buffered cohort
            # aggregates are live at once; stream: the cohort aggregates and
            # ONE accumulator, whatever the cohort sizes
            if reduce_mode == "decode":
                rep.peak_live_trees = len(landed) + len(reductions)
            else:
                rep.peak_live_trees = len(reductions) + 1 if reductions else 0
            new_global = self.policy.on_round_end(global_tree)
        self._close_round(rep, new_global, cohort_finishes)
        if self.tracer is not None:
            self._emit_hier_spans(rep, t0, down_t, cohort_trace)
        return rep

    # ------------------------------------------------------------------
    def _run_async(self, global_tree, program, db) -> RoundReport:
        rep = RoundReport(global_params=global_tree)
        participants, rep.unavailable = self._split_roster()
        t0 = self.clock
        deadline = self.deadline_s
        down_t = {cid: self.downlink.transfer_time(db(cid))
                  for cid in participants}
        queue = EventQueue()
        # (snapshot tree, version at download) per in-flight client
        snapshots: Dict[str, Tuple[Any, int]] = {}
        tev: List[Dict[str, Any]] = []     # trace records (tracer attached)
        for cid in participants:
            snapshots[cid] = (global_tree, self.version)
            rep.traffic.record(cid, down=db(cid))
            queue.push(t0 + down_t[cid] + self.specs[cid].compute_time_s,
                       FINISH, cid, payload={"cycle": 1})
            if self.tracer is not None:
                tev.append({"kind": "down", "cid": cid, "t0": t0,
                            "t1": t0 + down_t[cid], "bytes": db(cid),
                            "cycle": 1})

        # under the compressed-domain reduce, in-flight ARRIVE payloads
        # carry WIRE encodings, decoded at arrival: one live decoded tree
        # however many uplinks are in flight
        stream = self.server_reduce != "decode"
        live_payloads = peak_payloads = 0
        last_t = t0
        while queue:
            ev = queue.pop()
            last_t = max(last_t, ev.time)
            cid = ev.client_id
            spec = self.specs[cid]
            if ev.kind == FINISH:
                snap_tree, snap_ver = snapshots[cid]
                res = program.run([cid], snap_tree)[0]
                with span("uplink", client=cid):
                    if stream:
                        enc, up_b, delta, is_delta = self._encode_uplink(
                            cid, snap_tree, res.params)
                        cerr = codec_rel_error(self.codec_name, enc, delta)
                    else:
                        decoded, up_b, cerr = self._codec_roundtrip(
                            cid, snap_tree, res.params)
                if stream:
                    # the snapshot rides along: the delta rebases onto it,
                    # and snapshots[cid] may advance before this arrives
                    payload = {"enc": enc, "is_delta": is_delta,
                               "snap_tree": snap_tree}
                else:
                    payload = {"decoded": decoded}
                    live_payloads += 1
                    peak_payloads = max(peak_payloads, live_payloads)
                rep.traffic.record(cid, up=up_b,
                                   lan=self._lan_by.get(cid, 0))
                rep.client_infos.append((cid, res.info))
                rep.codec_error[cid] = cerr
                # the opt state rides with the arrival: it commits only if
                # the update lands inside the deadline
                payload.update({"snap_ver": snap_ver,
                                "cycle": ev.payload["cycle"],
                                "opt_state": res.opt_state})
                up_t = self.uplink.transfer_time(up_b)
                queue.push(ev.time + up_t, ARRIVE, cid, payload=payload)
                if self.tracer is not None:
                    tev.append({"kind": "exec", "cid": cid,
                                "t0": ev.time - spec.compute_time_s,
                                "t1": ev.time,
                                "cycle": ev.payload["cycle"]})
                    tev.append({"kind": "up", "cid": cid, "t0": ev.time,
                                "t1": ev.time + up_t, "bytes": up_b})
                continue
            # ARRIVE
            if not stream:
                live_payloads -= 1
            rep.finish_s[cid] = ev.time - t0      # last arrival per client
            staleness = self.version - ev.payload["snap_ver"]
            late = bool(deadline and ev.time - t0 > deadline)
            if self.tracer is not None:
                tev.append({"kind": "arrive", "cid": cid, "t": ev.time,
                            "staleness": staleness, "landed": not late})
            if late:
                rep.stragglers.append(cid)
                continue
            rep.staleness[cid] = staleness
            rep.staleness_events.append(staleness)
            with span("reduce"):
                if not stream:
                    update_tree = ev.payload["decoded"]
                elif ev.payload["is_delta"]:
                    update_tree = fused_decode_apply(
                        self.codec_name, ev.payload["snap_tree"],
                        ev.payload["enc"])
                else:
                    update_tree = decode_enc(
                        self.codec_name, ev.payload["enc"],
                        ev.payload["snap_tree"])
                global_tree, bumped = self.policy.on_update(
                    global_tree,
                    ClientUpdate(cid, update_tree, spec.weight, staleness,
                                 ev.time))
            if bumped:
                self.version += 1
            if cid not in rep.participated:
                rep.participated.append(cid)
            if ev.payload["opt_state"] is not None:
                rep.opt_states[cid] = ev.payload["opt_state"]
            cycle = ev.payload["cycle"]
            if cycle < self.cfg.async_cycles:
                snapshots[cid] = (global_tree, self.version)
                rep.traffic.record(cid, down=db(cid))
                queue.push(ev.time + down_t[cid] + spec.compute_time_s,
                           FINISH, cid, payload={"cycle": cycle + 1})
                if self.tracer is not None:
                    tev.append({"kind": "down", "cid": cid, "t0": ev.time,
                                "t1": ev.time + down_t[cid],
                                "bytes": db(cid), "cycle": cycle + 1})

        with span("reduce"):
            global_tree = self.policy.on_round_end(global_tree)
        self.version += 1 if rep.participated else 0
        rep.peak_live_trees = (1 if rep.client_infos else 0) if stream \
            else peak_payloads
        rep.round_time_s = last_t - t0
        self.clock = last_t
        rep.clock_s = self.clock
        rep.global_params = global_tree
        rep.version = self.version
        if self.tracer is not None:
            self._emit_async_spans(rep, t0, last_t, tev)
        return rep
