"""Discrete-event federation round engine.  Port of ``repro/fed/engine.py``
for the sync barrier round with the decode server reduce; the async event
loop, the compressed-domain reduce and the edge hierarchy wait for ROADMAP
Queue A item 6, spans and digests for item 8.

Each round, every available client

  1. downloads the server's fake batches      (downlink, LinkModel-priced),
  2. runs local discriminator training       (compute, priced by the
     paper's analytic model ``core/simulate.plan_epoch_time``),
  3. uplinks its discriminator through the codec (``fed/transport``) —
     lossy codecs compress the delta vs the downloaded tree, after the
     optional pre-codec ``uplink_stage`` (uplink DP) privatized it — and
  4. the server aggregates per its policy     (``fed/policies``).

Sync mode is a barrier with batched dispatch: all clients that can possibly
meet the deadline are handed to the program as ONE ``run`` call (a
roster-order loop, host-RNG identical to the sequential trainer).  A
``deadline_s`` drops straggler updates whose virtual finish time exceeds it;
their download, LAN and compute are still counted.  Only updates that land
commit their optimizer state (``RoundReport.opt_states``).

The clock the engine advances is *virtual* (the paper's Fig-2 time model
extended with WAN transfers); the tensor math runs on whatever device holds
the parameters.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.fed.events import make_availability
from repro_torch.fed.policies import ClientUpdate, make_policy
from repro_torch.fed.programs import as_program
from repro_torch.fed.transport import (LinkModel, TrafficLedger, apply_delta,
                                      delta_tree, make_codec, tree_rel_error)


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

    @property
    def mean_staleness(self) -> float:
        if not self.staleness_events:
            return 0.0
        return sum(self.staleness_events) / len(self.staleness_events)


class FederationEngine:
    def __init__(self, fed_cfg, specs: List[ClientSpec], *,
                 weighted: bool = True, uplink_stage=None):
        if fed_cfg.mode != "sync":
            raise NotImplementedError(
                f"fed.mode={fed_cfg.mode!r} is not ported to repro_torch yet "
                f"(ROADMAP Queue A item 6: async engine)")
        if fed_cfg.server_reduce != "decode":
            raise NotImplementedError(
                f"fed.server_reduce={fed_cfg.server_reduce!r} is not ported "
                f"to repro_torch yet (ROADMAP Queue A item 6)")
        if fed_cfg.hierarchy_cohorts >= 2:
            raise NotImplementedError(
                "fed.hierarchy_cohorts >= 2 is not ported to repro_torch yet "
                "(ROADMAP Queue A item 6: edge hierarchy)")
        self.cfg = fed_cfg
        self.roster = [s.client_id for s in specs]
        self.specs = {s.client_id: s for s in specs}
        self.weighted = bool(weighted)
        self.policy = make_policy(fed_cfg, weighted=weighted)
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
        self.availability = make_availability(fed_cfg.availability,
                                              fed_cfg.availability_seed)
        self.clock = 0.0
        self.round_idx = 0
        self.version = 0
        self.ledger = TrafficLedger()      # cumulative across rounds
        self._lan_by: Dict[str, int] = {}  # this round's LAN bytes/client

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
        rep = self._run_sync(global_tree, program, db)
        self.round_idx += 1
        for cid in rep.traffic.up_bytes:
            self.ledger.record(cid, up=rep.traffic.up_bytes[cid])
        for cid in rep.traffic.down_bytes:
            self.ledger.record(cid, down=rep.traffic.down_bytes[cid])
        for cid in rep.traffic.lan_bytes:
            self.ledger.record(cid, lan=rep.traffic.lan_bytes[cid])
        return rep

    # ------------------------------------------------------------------
    def _run_sync(self, global_tree, program, db) -> RoundReport:
        rep = RoundReport(global_params=global_tree)
        participants, rep.unavailable = self._split_roster()
        deadline = self.deadline_s
        down_t = {cid: self.downlink.transfer_time(db(cid))
                  for cid in participants}
        finishes: List[float] = []

        # batched dispatch: every client that can possibly meet the
        # deadline executes in ONE program.run call; provably-late clients
        # never run, so no work — and no host RNG — is spent on them
        runnable: List[str] = []
        for cid in participants:
            if deadline and down_t[cid] + self.specs[cid].compute_time_s \
                    > deadline:
                rep.stragglers.append(cid)
                rep.traffic.record(cid, down=db(cid))
                # never ran: record the known lower bound on its finish
                rep.finish_s[cid] = (down_t[cid]
                                     + self.specs[cid].compute_time_s)
            else:
                runnable.append(cid)
        results = program.run(runnable, global_tree)

        for res in results:
            cid = res.client_id
            spec = self.specs[cid]
            decoded, up_b, cerr = self._codec_roundtrip(cid, global_tree,
                                                       res.params)
            finish = down_t[cid] + spec.compute_time_s \
                + self.uplink.transfer_time(up_b)
            rep.traffic.record(cid, up=up_b, down=db(cid),
                               lan=self._lan_by.get(cid, 0))
            rep.client_infos.append((cid, res.info))
            rep.finish_s[cid] = finish
            rep.codec_error[cid] = cerr
            if deadline and finish > deadline:
                rep.stragglers.append(cid)     # ran, but its update is late
                continue                       # nothing commits — not even
                                               # its optimizer state
            rep.participated.append(cid)
            if res.opt_state is not None:
                rep.opt_states[cid] = res.opt_state
            rep.staleness[cid] = 0
            rep.staleness_events.append(0)
            finishes.append(finish)
            self.policy.on_update(
                global_tree, ClientUpdate(cid, decoded, spec.weight,
                                          0, self.clock + finish))

        new_global = self.policy.on_round_end(global_tree)
        if rep.participated:
            self.version += 1
        # the sync barrier releases at the slowest survivor — or at the
        # deadline when stragglers were waited out that long
        rep.round_time_s = max(finishes) if finishes else 0.0
        if deadline and rep.stragglers:
            rep.round_time_s = max(rep.round_time_s, deadline)
        self.clock += rep.round_time_s
        rep.clock_s = self.clock
        rep.global_params = new_global
        rep.version = self.version
        return rep
