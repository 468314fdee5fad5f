"""Discrete-event federation round engine.  Port of ``repro/fed/engine.py``
(span emission, codec and mesh swaps and digests wait for ROADMAP Queue A
items 7-8).

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
        self.codecs = {cid: make_codec(fed_cfg.codec,
                                       topk_frac=fed_cfg.topk_frac,
                                       error_feedback=fed_cfg.error_feedback)
                       for cid in self.roster}
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
                  lan_bytes_by_client: Optional[Dict[str, int]] = None
                  ) -> RoundReport:
        """One FL round.  ``program``: a client program (``fed/programs``)
        or a bare callable.  ``down_bytes``: server->client fake payload;
        ``down_bytes_by_client`` overrides it per client (clients on a
        longer ``local_steps`` schedule download more fake batches).
        ``lan_bytes_by_client``: split-boundary bytes of one local round,
        recorded per *execution*, straggler or not."""
        program = as_program(program)
        down_by = dict(down_bytes_by_client or {})
        db = lambda cid: down_by.get(cid, down_bytes)  # noqa: E731
        self._lan_by = dict(lan_bytes_by_client or {})
        if self.cfg.mode != "sync":
            rep = self._run_async(global_tree, program, db)
        elif self.hierarchy is not None:
            rep = self._run_sync_hier(global_tree, program, db)
        else:
            rep = self._run_sync(global_tree, program, db)
        self.round_idx += 1
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
    def _run_sync(self, global_tree, program, db) -> RoundReport:
        rep = RoundReport(global_params=global_tree)
        participants, rep.unavailable = self._split_roster()
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
            agg = StreamingAggregator(self.codec_name,
                                      use_kernel=self.cfg.kernel_aggregation)
            agg.init(global_tree)

        for res in results:
            cid = res.client_id
            spec = self.specs[cid]
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
                    rep.codec_error[cid] = codec_rel_error(
                        self.codec_name, enc, delta)
                rep.stragglers.append(cid)     # ran, but its update is late
                continue                       # nothing commits — not even
                                               # its optimizer state
            self._land(rep, cid, res.opt_state)
            finishes.append(finish)
            if reduce_mode == "stream":
                # fold now; the error rides the same sweep
                err = agg.fold(enc, self._weight(cid), delta=delta)
                rep.codec_error[cid] = 0.0 if err is None else err
            elif reduce_mode == "batched":
                staged.append((enc, self._weight(cid)))
                rep.codec_error[cid] = codec_rel_error(
                    self.codec_name, enc, delta)
            else:
                self.policy.on_update(
                    global_tree, ClientUpdate(cid, decoded, spec.weight,
                                              0, self.clock + finish))

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
                    use_kernel=self.cfg.kernel_aggregation)
            else:
                mean = None
            if mean is None:
                new_global = global_tree
            else:
                new_global = apply_delta(global_tree, mean) if is_delta \
                    else mean
            rep.peak_live_trees = 1 if rep.participated else 0
        return self._close_round(rep, new_global, finishes)

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

        # per cohort: edge pre-reduce, then ONE WAN uplink per cohort
        if reduce_mode == "decode":
            reductions = self.hierarchy.reduce_all(landed)
        else:
            reductions = self.hierarchy.reduce_all_streaming(
                landed, global_tree, codec_name=self.codec_name)
        cohort_finishes: List[float] = []
        for red in reductions:
            aggregate = red.aggregate
            if reduce_mode != "decode" and is_delta:
                # the stream reduce yields the cohort's mean DELTA; rebase
                # it so the WAN payload is the full tree the decode path
                # ships
                aggregate = apply_delta(global_tree, aggregate)
            wan_b = tree_bytes(aggregate)
            finish = max(edge_finish[m] for m in red.members) \
                + self.uplink.transfer_time(wan_b)
            ckey = f"cohort{red.cohort}"
            rep.traffic.record(ckey, up=wan_b)
            cohort_finishes.append(finish)
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
        return self._close_round(rep, new_global, cohort_finishes)

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
        for cid in participants:
            snapshots[cid] = (global_tree, self.version)
            rep.traffic.record(cid, down=db(cid))
            queue.push(t0 + down_t[cid] + self.specs[cid].compute_time_s,
                       FINISH, cid, payload={"cycle": 1})

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
                if stream:
                    enc, up_b, delta, is_delta = self._encode_uplink(
                        cid, snap_tree, res.params)
                    cerr = codec_rel_error(self.codec_name, enc, delta)
                    # the snapshot rides along: the delta rebases onto it,
                    # and snapshots[cid] may advance before this arrives
                    payload = {"enc": enc, "is_delta": is_delta,
                               "snap_tree": snap_tree}
                else:
                    decoded, up_b, cerr = self._codec_roundtrip(
                        cid, snap_tree, res.params)
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
                queue.push(ev.time + self.uplink.transfer_time(up_b),
                           ARRIVE, cid, payload=payload)
                continue
            # ARRIVE
            if not stream:
                live_payloads -= 1
            rep.finish_s[cid] = ev.time - t0      # last arrival per client
            if deadline and ev.time - t0 > deadline:
                rep.stragglers.append(cid)
                continue
            staleness = self.version - ev.payload["snap_ver"]
            rep.staleness[cid] = staleness
            rep.staleness_events.append(staleness)
            if not stream:
                update_tree = ev.payload["decoded"]
            elif ev.payload["is_delta"]:
                update_tree = fused_decode_apply(
                    self.codec_name, ev.payload["snap_tree"],
                    ev.payload["enc"])
            else:
                update_tree = decode_enc(self.codec_name, ev.payload["enc"],
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

        global_tree = self.policy.on_round_end(global_tree)
        self.version += 1 if rep.participated else 0
        rep.peak_live_trees = (1 if rep.client_infos else 0) if stream \
            else peak_payloads
        rep.round_time_s = last_t - t0
        self.clock = last_t
        rep.clock_s = self.clock
        rep.global_params = global_tree
        rep.version = self.version
        return rep
