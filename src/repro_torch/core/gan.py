"""FSL-GAN training (paper §3-§5).  Port of ``repro/core/gan.py``.

Roles:
  * **Server** owns the generator G. It never sees real data — it only ships
    generated (fake) images to clients and receives averaged discriminator
    parameters, which is the paper's privacy argument.
  * **Clients** each own a discriminator replica D_c trained on their local
    real data + the server's fakes. After their local round the D
    parameters are FedAvg'd (weighted by client example counts).
  * Within a client, D training is *split* across that client's devices
    per the SplitPlan (core/split.py).  With ``cfg.split.enabled`` the plan
    IS the local step: forward/backward execute device segment by device
    segment (SplitExecution), every boundary tensor passes the configured
    boundary stage (identity | transport codec | DP noise, the fused
    ``codec+dp`` stage through the boundary_fuse CUDA kernel with
    ``split.use_kernel``), and round time + LAN bytes are priced from the
    measured per-boundary payloads.  ``split.pipeline_microbatches`` > 1
    runs the 1F1B-pipelined step over micro-batches, priced by the overlap
    schedule's makespan; under DP-SGD the split runs per example.
    Disabled, the plan only prices the round and the monolithic D trains,
    as in the paper's Colab runs.

Losses: non-saturating DCGAN BCE.
    L_D = BCE(D(x_real), 1) + BCE(D(G(z)), 0)
    L_G = BCE(D(G(z)), 1)

``train_epoch`` runs one federation-engine round per epoch (sync barrier,
flat or through the edge hierarchy, or the async FedAsync/FedBuff modes;
any uplink codec; the decode, stream or batched server reduce, which
``fed.kernel_aggregation`` sends through the fedavg and agg_fuse CUDA
kernels).  The backend (``fed.backend``) runs the clients' local rounds as
a per-client loop (``loop``), as one stacked step a batch for the clients
of a split signature (``vectorized``, on the client mesh with
``fed.shard_clients``), or as whichever a timed probe finds faster
(``auto``).  Privacy (``cfg.privacy``) is
DP-SGD inside the local step (the dp_clip CUDA kernel with
``privacy.use_kernel``) or the pre-codec uplink DP stage in the engine,
with an RDP accountant either way.  ``train_epoch_sequential`` keeps the
plain sequential loop; with the host FedAvg the two are bit-for-bit
identical (pinned in the tests).

The control plane (``cfg.control``) wraps each round: every round emits
one :class:`~repro_torch.control.RoundFeedback` (``self.feedback``), and
under ``mode='adaptive'`` the controller suite turns that history into
knob decisions before the next round (codec swap, sigma rebind, split
replan and per-boundary stages, deadline).  The flight recorder
(``cfg.obs``) traces the engine's rounds, persists feedback, knobs,
metrics, alerts and state digests, and profiles the round's kernels; the
health monitors (``cfg.obs.health``) check each round and act per policy.
Neither steers training: obs-on and ``policy='record'`` are bit-exact with
them off, and ``mode='frozen'`` with the uncontrolled build.

The entry points (``train_epoch``, ``train_epoch_sequential``,
``generate``) compute convolutions in float32 whatever the global cuDNN
TF32 flag says (:func:`repro_torch.device.fp32_convolutions`).
"""
from __future__ import annotations

import functools
import time
import warnings
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import keys
from repro_torch.config import RunConfig
from repro_torch.control import (ControllerSuite, ControlKnobs, RoundFeedback,
                                 knobs_from_config, make_controllers)
from repro_torch.core.devices import make_pool
from repro_torch.core.fedavg import fedavg
from repro_torch.core.pipeline import effective_microbatches
from repro_torch.core.selection import plan_all_clients
from repro_torch.core.simulate import plan_epoch_time
from repro_torch.core.split import (SplitExecution, SplitPlan,
                                    make_boundary_stage, plan_segments)
from repro_torch.device import fp32_convolutions, resolve_device
from repro_torch.fed.engine import ClientSpec, FederationEngine
from repro_torch.fed.hierarchy import assign_cohorts
from repro_torch.fed.programs import (BACKENDS, ClientHyper, LocalProgram,
                                      RoundExecutor)
from repro_torch.fed.transport import apply_delta, delta_tree, fake_batch_bytes
from repro_torch.launch.mesh import make_client_mesh, mesh_chips
from repro_torch.models.dcgan import (disc_apply, disc_apply_layer, disc_init,
                                      disc_layer_costs, disc_layer_names,
                                      gen_apply, gen_init)
from repro_torch.obs import FlightRecorder, profile_engine_kernels
from repro_torch.obs.digest import RoundDigest, state_digest, tree_digest
from repro_torch.obs.health import (SEV_FATAL, HealthAbort, HealthAlert,
                                    HealthMonitor)
from repro_torch.obs.trace import span
from repro_torch.optim import make_optimizer
from repro_torch.privacy.defenses import (RDPAccountant, make_dp_d_step,
                                          make_uplink_stage)
from repro_torch.privacy.metrics import distance_correlation
from repro_torch.tree import leaves, tree_map, value_and_grad


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Numerically-stable binary cross entropy with logits."""
    l = logits.to(torch.float32)
    t = torch.full_like(l, target)
    return torch.mean(torch.clamp(l, min=0) - l * t
                      + torch.log1p(torch.exp(-torch.abs(l))))


def d_loss_fn(d_params, real, fake, c) -> torch.Tensor:
    return (bce_logits(disc_apply(d_params, real, c), 1.0)
            + bce_logits(disc_apply(d_params, fake, c), 0.0))


def g_loss_fn(g_params, d_params, z, c) -> torch.Tensor:
    fake = gen_apply(g_params, z, c)
    return bce_logits(disc_apply(d_params, fake, c), 1.0)


# backend="auto": timed dispatches a backend after its warm-up; the probe
# keeps each backend's fastest.  Host noise only adds time, and on the card
# one sample let a spike flip a pick between backends 7-12% apart
AUTO_PROBE_RUNS = 3


@dataclass
class GANState:
    g_params: Any
    g_opt: Any
    d_params: Dict[str, Any]          # per-client discriminator replicas
    d_opt: Dict[str, Any]
    step: int = 0
    history: Dict[str, List[float]] = field(default_factory=dict)


class FSLGANTrainer:
    """Paper-faithful simulation (clients share one accelerator, exactly
    like the paper's Colab runs).  Runs on the GPU unless ``device`` names
    another device."""

    def __init__(self, cfg: RunConfig, client_data: Dict[str, np.ndarray],
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.c = cfg.model.dcgan
        self.client_ids = list(client_data)
        self.client_data = client_data
        self.batch_size = cfg.shape.global_batch
        gen = torch.Generator().manual_seed(seed)
        self.g_optimizer = make_optimizer(cfg.optim)
        self.d_optimizer = make_optimizer(cfg.optim)
        g_params = gen_init(gen, self.c, self.device)
        d0 = disc_init(gen, self.c, self.device)
        self.state = GANState(
            g_params=g_params,
            g_opt=self.g_optimizer.init(g_params),
            d_params={cid: tree_map(torch.clone, d0)
                      for cid in self.client_ids},
            d_opt={cid: self.d_optimizer.init(d0) for cid in self.client_ids},
        )
        # control plane (cfg.control): knobs seed from the static config;
        # 'frozen' (default) never changes them — bit-exact with the
        # uncontrolled build — while 'adaptive' consults the controller
        # suite between rounds.  RoundFeedback is emitted either way.
        self.knobs: ControlKnobs = knobs_from_config(cfg)
        self.feedback: List[RoundFeedback] = []
        self._suite: Optional[ControllerSuite] = None
        # split planning.  cfg.split.enabled compiles each plan into the
        # executed local step (core/split.SplitExecution); otherwise the
        # plan only prices the round and training runs the monolithic D.
        self.pool = make_pool(cfg.fsl.heterogeneity, cfg.fsl.num_clients,
                              cfg.fsl.devices_per_client, cfg.fsl.seed)
        costs = disc_layer_costs(self.c)
        self._layers = [(n, costs[n]) for n in disc_layer_names(self.c)]
        self.plans: Dict[str, SplitPlan] = plan_all_clients(
            self.pool, self._layers, self.knobs.split_strategy, cfg.fsl.seed)
        # the host stream for data sampling and z, as in the JAX trainer
        self._rng = np.random.default_rng(seed)
        self._build_steps()
        # privacy (cfg.privacy): DP-SGD inside the local step, the
        # pre-codec uplink stage, and an RDP accountant.  ONE uplink stage
        # for the trainer's lifetime: an engine rebuild must not reset its
        # per-client round counters, or a noise draw would repeat.
        priv = cfg.privacy
        self._dp_step = None
        self.accountant: Optional[RDPAccountant] = None
        self._uplink_stage = make_uplink_stage(priv)
        if priv.enabled:
            # the accountant's subsampling amplification assumes Poisson
            # sampling at rate q; the loader samples uniformly with
            # replacement, so 1.0 (no amplification claimed) is the default
            self.accountant = RDPAccountant(priv.noise_multiplier,
                                            priv.sample_rate)
            if priv.mode == "dp_sgd":
                # the sequential reference's DP step (the engine's program
                # builds its own from the same definition in fed/programs)
                self._dp_step = make_dp_d_step(
                    self.d_optimizer,
                    functools.partial(d_loss_fn, c=self.c),
                    self.cfg.optim.lr, priv.clip_norm,
                    priv.noise_multiplier, use_kernel=priv.use_kernel)
        # federation runtime (built on first train_epoch — compute times
        # depend on batches_per_client)
        self.engine: Optional[FederationEngine] = None
        self._engine_batches: Optional[int] = None
        self._cohort_of: Optional[Callable[[str], int]] = None
        # backend="auto": the probe's pick, pinned for the trainer's life
        # after the first round (its wall times go into that round's
        # RoundFeedback)
        self._auto_backend: Optional[str] = None
        # the client mesh, resolved on first use (_client_mesh)
        self._mesh = None
        self._mesh_resolved = False
        # mean analytic sequential/pipelined per-batch ratio across split
        # clients (1.0 unsplit or K == 1); set by _ensure_engine, carried
        # into RoundFeedback for the deadline controller's rescaling
        self._pipeline_speedup: float = 1.0
        # flight recorder (cfg.obs): traces, metrics, feedback persistence.
        # Disabled (default) => None everywhere — the engine emits no spans
        # and every training path is untouched (pinned bit-exact).
        self.recorder: Optional[FlightRecorder] = None
        self._trace_timelines: Dict[str, Any] = {}
        self._manifest_written = False
        self._profiled = False
        if cfg.obs.enabled:
            self.recorder = FlightRecorder.from_config(cfg)
        # watchtower (cfg.obs.health): read-only per-round monitors.
        # Orthogonal to the recorder — monitors run without persistence
        # (alerts stay on self.health_alerts), and policy='record' is
        # bit-exact with monitors off because checks never write training
        # state.  Rollback keeps one snapshot of the last healthy state.
        self.monitor: Optional[HealthMonitor] = None
        self.health_alerts: List[HealthAlert] = []
        self._healthy_snapshot: Optional[Tuple[Any, Any, Any, Any]] = None
        if cfg.obs.health.enabled:
            self.monitor = HealthMonitor(cfg.obs.health)

    # ------------------------------------------------------------------
    def _build_steps(self):
        c, lr = self.c, self.cfg.optim.lr
        d_vg = value_and_grad(functools.partial(d_loss_fn, c=c))
        g_vg = value_and_grad(functools.partial(g_loss_fn, c=c))

        def d_step(d_params, d_opt, real, fake):
            loss, grads = d_vg(d_params, real, fake)
            d_params, d_opt = self.d_optimizer.update(grads, d_opt, d_params,
                                                      lr)
            return d_params, d_opt, loss

        def g_step(g_params, g_opt, d_params, z):
            loss, grads = g_vg(g_params, d_params, z)
            g_params, g_opt = self.g_optimizer.update(grads, g_opt, g_params,
                                                      lr)
            return g_params, g_opt, loss

        @torch.no_grad()
        def gen_batch(g_params, z):
            return gen_apply(g_params, z, c)

        self._d_step, self._g_step, self._gen = d_step, g_step, gen_batch
        self._build_split_programs()

    def _boundary_stages(self, plan: SplitPlan) -> Optional[List[Any]]:
        """Per-boundary stage list for one plan under the current knobs, or
        None for the uniform config stage (the static path)."""
        stage_map = self.knobs.stage_by_boundary
        if stage_map is None:
            return None
        nb = len(plan_segments(plan)) - 1
        base = self.cfg.split.boundary_stage or "identity"
        return [make_boundary_stage(self.cfg.split, stage_map.get(b, base))
                for b in range(nb)]

    def _build_split_programs(self):
        """(Re)build the split executions and the client program from the
        current plans and knobs.  Called at construction and again by the
        split controller after a replan or a per-boundary stage
        reassignment (a *split-signature regroup*: new signatures, new
        step caches).  Each feasible plan becomes a staged local step
        whose boundary tensors pass their stage; its measured per-step LAN
        bytes are kept for pricing."""
        c, lr = self.c, self.cfg.optim.lr
        self.split_execs: Dict[str, SplitExecution] = {}
        self._split_step_bytes: Dict[str, int] = {}
        self._split_hop_events: Dict[str, List[int]] = {}
        if self.cfg.split.enabled:
            stage = make_boundary_stage(self.cfg.split)
            apply_layer = functools.partial(disc_apply_layer, c=c)
            tails = (functools.partial(bce_logits, target=1.0),
                     functools.partial(bce_logits, target=0.0))
            x_shape = (self.batch_size, c.image_size, c.image_size,
                       c.channels)
            # wire bytes are a function of (split signature, x_shape):
            # measure once per signature
            bytes_by_sig: Dict[Any, Tuple[int, List[Dict[str, int]]]] = {}
            pipeline_k = self._pipeline_k()
            for cid, plan in self.plans.items():
                ex = SplitExecution(plan, apply_layer, tails, stage=stage,
                                    stages=self._boundary_stages(plan),
                                    pipeline_microbatches=pipeline_k)
                self.split_execs[cid] = ex
                if ex.signature not in bytes_by_sig:
                    bytes_by_sig[ex.signature] = ex.step_wire_bytes(
                        self.state.d_params[cid], x_shape)
                total, per_b = bytes_by_sig[ex.signature]
                self._split_step_bytes[cid] = total
                # per-batch LAN hop events: at each boundary one fwd and
                # one bwd crossing, each carrying both passes' tensors
                self._split_hop_events[cid] = [
                    ex.num_passes * b[d] for b in per_b
                    for d in ("fwd", "bwd")]
        self.program = LocalProgram(
            self.d_optimizer, functools.partial(d_loss_fn, c=c), lr,
            privacy=self.cfg.privacy, split=self.split_execs or None)
        # a controller-retuned sigma survives split regroups: the program
        # is rebuilt from the static config, so rebind the live knob
        if self.program.is_dp \
                and self.knobs.sigma != self.cfg.privacy.noise_multiplier:
            self.program.rebind_sigma(self.knobs.sigma)

    def _d_update(self, dp, do, real, fake, key):
        """One reference D step for ``train_epoch_sequential``: DP-SGD when
        ``cfg.privacy`` says so (accounted per batch, noise from ``key``),
        the plain step otherwise."""
        if self._dp_step is not None:
            if self.accountant is not None:
                self.accountant.step()
            return self._dp_step(dp, do, real, fake, key)
        return self._d_step(dp, do, real, fake)

    def _round_key(self) -> Optional[keys.Key]:
        """Root noise key of this round — (privacy.seed, round) under
        DP-SGD, (split.seed, round) for a stochastic boundary stage alone,
        None when the step draws no noise.  The engine's executor extends
        it by (cohort, client roster index, execution index) and the step
        by the batch index."""
        if self.program.is_dp:
            return keys.fold_in(keys.root(keys.DP_SGD,
                                          self.cfg.privacy.seed),
                                self.state.step)
        if self.program.needs_key:
            return keys.fold_in(keys.root(keys.STAGE, self.cfg.split.seed),
                                self.state.step)
        return None

    def _sample_real(self, cid: str, n: int) -> torch.Tensor:
        data = self.client_data[cid]
        idx = self._rng.integers(0, len(data), n)
        return torch.from_numpy(data[idx]).to(self.device)

    def _z(self, n: int) -> torch.Tensor:
        return torch.from_numpy(self._rng.standard_normal(
            (n, self.c.latent_dim), dtype=np.float32)).to(self.device)

    # ------------------------------------------------------------------
    # federation-runtime glue
    # ------------------------------------------------------------------
    def _active_clients(self) -> List[str]:
        """Clients with a feasible split plan (paper: infeasible clients are
        dropped); all clients if planning found none feasible."""
        return [cid for cid in self.client_ids if cid in self.plans] \
            or self.client_ids

    def _client_steps(self, cid: str, default: int) -> int:
        return int(self.cfg.fed.client_local_steps.get(cid, default))

    def _lan_latency_s(self) -> float:
        """Per-hop LAN latency: the ``cfg.split.lan_latency_s`` override
        when set, else the paper's ``cfg.fsl.lan_latency_s`` (50 ms)."""
        return self.cfg.split.lan_latency_s or self.cfg.fsl.lan_latency_s

    def _pipeline_k(self) -> int:
        """Micro-batches per batch for the pipelined split step: the
        configured K clamped to a divisor of the batch size (1 when split
        execution is off)."""
        if not self.cfg.split.enabled:
            return 1
        return effective_microbatches(self.batch_size,
                                      self.cfg.split.pipeline_microbatches)

    def _ensure_engine(self, batches_per_client: int) -> FederationEngine:
        """(Re)build the engine when the local-round length changes — client
        compute times are priced per round.  Rebuilding resets the virtual
        clock, not any training state."""
        if self.engine is not None \
                and self._engine_batches == batches_per_client:
            return self.engine
        by_id = {cl.client_id: cl for cl in self.pool}
        specs = []
        pipeline_k = self._pipeline_k()
        speedups: List[float] = []
        for cid in self._active_clients():
            steps = self._client_steps(cid, batches_per_client)
            if cid in self.plans and cid in by_id:
                # split-executed clients are priced from the MEASURED
                # per-boundary bytes their step ships; unsplit training
                # keeps the analytic hop constant.  A pipelined step is
                # priced by the 1F1B schedule's makespan
                price = functools.partial(
                    plan_epoch_time,
                    self.plans[cid], by_id[cid], batches_per_epoch=steps,
                    lan_latency_s=self._lan_latency_s(),
                    boundary_bytes=self._split_hop_events.get(cid),
                    lan_bandwidth_bps=self.cfg.split.lan_bandwidth_bps)
                ct = price(pipeline_microbatches=pipeline_k)
                if pipeline_k > 1 and cid in self.split_execs and ct > 0.0:
                    speedups.append(price(pipeline_microbatches=1) / ct)
            else:
                ct = 0.0
            specs.append(ClientSpec(
                cid, float(len(self.client_data[cid])), ct,
                lr_scale=float(self.cfg.fed.client_lr_scales.get(cid, 1.0)),
                local_steps=steps))
        self._pipeline_speedup = float(np.mean(speedups)) if speedups \
            else 1.0
        # static cohort map of the edge hierarchy: roster order cut into
        # contiguous cohorts, shared by the engine's pre-reduce and the
        # executor's (round, cohort, client) key chain, so grouping and
        # noise keys cannot disagree
        self._cohort_of = None
        if self.cfg.fed.hierarchy_cohorts >= 2:
            grouped = assign_cohorts([s.client_id for s in specs],
                                     self.cfg.fed.hierarchy_cohorts)
            cmap = {cid: c for c, ms in grouped.items() for cid in ms}
            self._cohort_of = lambda cid: cmap.get(cid, 0)
        self.engine = FederationEngine(
            self.cfg.fed, specs, weighted=self.cfg.fsl.weighted_average,
            uplink_stage=self._uplink_stage, cohort_of=self._cohort_of)
        if self.cfg.fed.server_reduce == "batched":
            # the batched reduce cuts the round's wires over the client
            # mesh the vectorized backend trains on (None without one)
            self.engine.set_mesh(self._client_mesh())
        self._engine_batches = batches_per_client
        if self.recorder is not None:
            self._attach_recorder(by_id)
        return self.engine

    def _attach_recorder(self, by_id) -> None:
        """Hook the flight recorder into a (re)built engine: the tracer with
        a virtual-clock offset (a fresh engine's clock restarts at 0, the
        recording's timeline must stay monotone), the digester, the
        ledger's wire observers, and one split timeline per client for
        span subdivision."""
        rec = self.recorder
        if rec.wants("trace"):
            tr = rec.tracer
            tr.set_virtual_offset(tr.last_virtual_end())
            self.engine.set_tracer(tr, batch_cap=self.cfg.obs.trace_batches)
        if rec.wants("digests"):
            # stamp RoundReport.global_digest on the as-aggregated tree —
            # before any health action, so digests.jsonl shows what a
            # rolled-back round actually aggregated
            self.engine.set_digester(tree_digest)
        self.engine.ledger.observer = self._observe_wire
        self.engine.ledger.edge_observer = self._observe_edge
        self._trace_timelines = {}
        for cid, ex in self.split_execs.items():
            cl = by_id.get(cid)
            if cl is None:
                continue
            tf = {d.device_id: d.time_factor for d in cl.devices}
            # round_timeline emits overlapping 1F1B spans when the
            # executor is pipelined (K from ex.pipeline_microbatches)
            self._trace_timelines[cid] = ex.round_timeline(
                tf, lan_latency_s=self._lan_latency_s(),
                hop_bytes=self._split_hop_events.get(cid),
                lan_bandwidth_bps=self.cfg.split.lan_bandwidth_bps)

    def _observe_wire(self, cid: str, up: int, down: int, lan: int) -> None:
        """TrafficLedger observer -> per-client cumulative wire counters
        (the per-round totals come from RoundFeedback via observe_round;
        distinct namespaces, no double counting)."""
        reg = self.recorder.registry
        if up:
            reg.counter(f"wire.client.{cid}.up_bytes").inc(up)
        if down:
            reg.counter(f"wire.client.{cid}.down_bytes").inc(down)
        if lan:
            reg.counter(f"wire.client.{cid}.lan_bytes").inc(lan)

    def _observe_edge(self, cid: str, nbytes: int) -> None:
        """TrafficLedger edge observer -> per-client client->edge wire
        counter (the two-tier pre-reduce hop)."""
        if nbytes:
            self.recorder.registry.counter(
                f"wire.client.{cid}.edge_bytes").inc(nbytes)

    def _sample_round_batches(self, cid: str, steps: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``steps`` local batches for one client, sampled in the sequential
        loop's host-RNG order (real_t, z_t alternating): local reals +
        server fakes.  The server ships fakes; the client never shares
        ``real``."""
        st = self.state
        rs, fs = [], []
        for _ in range(steps):
            rs.append(self._sample_real(cid, self.batch_size))
            fs.append(self._gen(st.g_params, self._z(self.batch_size)))
        return torch.stack(rs), torch.stack(fs)

    def _hyper(self) -> Dict[str, ClientHyper]:
        """Per-client hyperparameter schedules, from the engine's
        ``ClientSpec``s (built in ``_ensure_engine``)."""
        return {cid: ClientHyper(lr_scale=spec.lr_scale,
                                 local_steps=spec.local_steps)
                for cid, spec in self.engine.specs.items()}

    def _bind_round(self, batches_per_client: int, backend: str
                    ) -> RoundExecutor:
        """Bind the client program to this round: data sampling, opt-state
        lookup, per-client hyperparameter schedules, the round's noise key
        and, under the vectorized backend, the client mesh."""
        return RoundExecutor(
            self.program, backend=backend,
            sample=self._sample_round_batches,
            opt_lookup=lambda cid: self.state.d_opt[cid],
            default_steps=batches_per_client, hyper=self._hyper(),
            round_key=self._round_key(),
            mesh=self._client_mesh() if backend == "vectorized" else None,
            cohort_of=self._cohort_of)

    def _client_mesh(self):
        """The ``clients`` mesh (``launch/mesh.make_client_mesh`` over the
        trainer's device type) when ``fed.shard_clients`` is on and the
        mesh has more than one device; None otherwise (one device: the
        unsharded dispatch)."""
        if not self.cfg.fed.shard_clients:
            return None
        if not self._mesh_resolved:
            mesh = make_client_mesh(device_type=self.device.type)
            self._mesh = mesh if mesh_chips(mesh) > 1 else None
            self._mesh_resolved = True
        return self._mesh

    def _num_shards(self, backend: str) -> int:
        """Mesh devices a round's stacked dispatch spans."""
        mesh = self._client_mesh() if backend == "vectorized" else None
        return 1 if mesh is None else mesh_chips(mesh)

    def _resolve_auto_backend(self, batches_per_client: int
                              ) -> Tuple[str, Dict[str, float]]:
        """``backend="auto"``: a one-shot timed probe of both backends.

        Runs each backend's full round dispatch over the active roster on
        zero batches, once to warm up (on the card that absorbs the
        kernels' first-use build and cuDNN's algorithm search) and then
        ``AUTO_PROBE_RUNS`` times timed, the backends alternating, the
        device synchronised before each clock read; each backend's time
        is its fastest run, and the faster backend is pinned for the
        trainer's life.  The probe draws no
        host RNG and commits nothing (``ClientResult`` is pure and
        dropped).  Returns ``(backend, probe_us)``; ``probe_us`` is empty
        on every round after the probe ran."""
        if self._auto_backend is not None:
            return self._auto_backend, {}
        cids = self._active_clients()
        c = self.c
        max_steps = max(self._client_steps(cid, batches_per_client)
                        for cid in cids)
        zeros = torch.zeros((max_steps, self.batch_size, c.image_size,
                             c.image_size, c.channels), device=self.device)
        key = keys.root(keys.DEFAULT, 0) if self.program.needs_key else None
        hyper = self._hyper()
        global_d = self.state.d_params[cids[0]]

        def run_once(be):
            RoundExecutor(
                self.program, backend=be,
                sample=lambda cid, steps: (zeros[:steps], zeros[:steps]),
                opt_lookup=lambda cid: self.state.d_opt[cid],
                default_steps=batches_per_client, hyper=hyper,
                round_key=key,
                mesh=self._client_mesh() if be == "vectorized" else None
            ).run(list(cids), global_d)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        for be in BACKENDS:
            run_once(be)
        probe_us: Dict[str, float] = {be: float("inf") for be in BACKENDS}
        for _ in range(AUTO_PROBE_RUNS):
            for be in BACKENDS:
                t0 = time.perf_counter()
                run_once(be)
                probe_us[be] = min(probe_us[be],
                                   (time.perf_counter() - t0) * 1e6)
        self._auto_backend = min(BACKENDS, key=lambda be: probe_us[be])
        return self._auto_backend, probe_us

    # ------------------------------------------------------------------
    # control plane (cfg.control)
    # ------------------------------------------------------------------
    def _adaptive(self) -> bool:
        return (self.cfg.control.mode == "adaptive"
                and bool(self.cfg.control.controllers))

    def _controller_inputs(self, batches_per_client: int
                           ) -> Tuple[List[int], int]:
        """The non-config inputs ``make_controllers`` needs: uplink-tree
        leaf sizes (codec byte prediction) and the expected DP releases per
        round.  Shared between the live suite build and the recorder's
        manifest — replay must rebuild the exact same suite."""
        leaf_sizes = [int(l.numel()) for l in leaves(
            self.state.d_params[self.client_ids[0]])]
        if self.cfg.privacy.mode == "dp_sgd":
            hint = sum(self._client_steps(cid, batches_per_client)
                       for cid in self._active_clients())
        else:                              # uplink: one release per client
            hint = len(self._active_clients())
        return leaf_sizes, hint

    def _ensure_controllers(self, batches_per_client: int) -> ControllerSuite:
        """Build the controller suite on first use (the DP steps-per-round
        hint depends on the round length)."""
        if self._suite is None:
            leaf_sizes, hint = self._controller_inputs(batches_per_client)
            self._suite = make_controllers(
                self.cfg, leaf_sizes=leaf_sizes, steps_per_round_hint=hint)
        return self._suite

    def _apply_knobs(self, new: ControlKnobs) -> None:
        """Apply a knob diff to the layers that own each knob.  Codec and
        deadline land on the engine (after ``_ensure_engine``, in
        ``train_epoch``); sigma rebinds the uplink stage in place and the
        DP-SGD program via ``LocalProgram.rebind_sigma``; split knobs
        replan and regroup the split programs (new signatures reprice the
        engine's client compute times)."""
        old, self.knobs = self.knobs, new
        if new.split_strategy != old.split_strategy:
            self.plans = plan_all_clients(self.pool, self._layers,
                                          new.split_strategy,
                                          self.cfg.fsl.seed)
            self.engine = None             # client times need repricing
        if (new.split_strategy != old.split_strategy
                or new.stage_by_boundary != old.stage_by_boundary) \
                and self.cfg.split.enabled:
            self._build_split_programs()   # split-signature regroup
            self.engine = None
        if new.sigma != old.sigma:
            if self._uplink_stage is not None:
                self._uplink_stage.noise_multiplier = float(new.sigma)
            self.program.rebind_sigma(new.sigma)

    def _probe_boundary_dcor(self) -> Dict[str, Tuple[float, ...]]:
        """Measured input-vs-activation distance correlation per boundary
        per split client, on a fixed data prefix — deterministic and
        host-RNG-free, so probing never perturbs training.

        Probes the RAW (pre-stage) boundary activation: the controller
        needs each boundary's *intrinsic* leak to decide protection.
        Probing post-stage would measure the noise it just assigned,
        suppress the signal, strip the stage next round, and oscillate.
        The deployed post-stage leakage is the attack suite's job, not the
        control signal's."""
        out: Dict[str, Tuple[float, ...]] = {}
        n = int(self.cfg.control.probe_batch)
        for cid in self._active_clients():
            ex = self.split_execs.get(cid)
            if ex is None or ex.num_boundaries == 0:
                continue
            data = self.client_data[cid]
            x0 = torch.from_numpy(data[:min(n, len(data))]).to(self.device)
            params, x, dcors = self.state.d_params[cid], x0, []
            with torch.no_grad():
                for dev, names in ex.segments[:-1]:
                    for name in names:
                        x = ex.apply_layer(name, params, x)
                    dcors.append(distance_correlation(x0, x))
            out[cid] = tuple(dcors)
        return out

    # ------------------------------------------------------------------
    # watchtower (cfg.obs.health)
    # ------------------------------------------------------------------
    def _snapshot_state(self) -> Tuple[Any, Any, Any, Any]:
        """Copy of the committed training state (all D replicas + opts, G
        params + opt) — what ``policy='rollback'`` restores.  Host RNG and
        the engine's clock and codec residuals are deliberately NOT
        captured: rollback restarts from healthy *parameters* with fresh
        data, it does not rewind time."""
        st = self.state
        return tuple(tree_map(torch.clone, t)
                     for t in (st.d_params, st.d_opt, st.g_params, st.g_opt))

    def _restore_snapshot(self) -> None:
        st = self.state
        # copies, so a later snapshot refresh never aliases live state
        st.d_params, st.d_opt, st.g_params, st.g_opt = (
            tree_map(torch.clone, t) for t in self._healthy_snapshot)

    def _apply_health_policy(self, alerts: List[HealthAlert]
                             ) -> Tuple[bool, bool, Optional[HealthAlert]]:
        """Turn this round's alerts into the configured action.  Returns
        ``(rolled_back, state_healthy, abort_alert)``; the caller records
        everything first and raises ``abort_alert`` last, so an aborting
        run still leaves a complete ``alerts.jsonl``.

        ``state_healthy`` is False only when a non-finite fatal fired and
        was NOT repaired — the caller must not refresh the rollback
        snapshot from poisoned state."""
        pol = self.cfg.obs.health.policy
        fatal = [a for a in alerts if a.severity == SEV_FATAL]
        poisoned = any(a.check in ("nonfinite_params", "nonfinite_loss")
                       for a in fatal)
        rolled, abort_alert = False, None
        if pol == "record":
            return rolled, not poisoned, abort_alert
        to_warn = list(alerts)
        if pol == "abort" and fatal:
            abort_alert = fatal[0]
            to_warn = [a for a in alerts if a is not abort_alert]
        elif pol == "rollback" and fatal:
            recoverable = [a for a in fatal if a.recoverable]
            if recoverable and self._healthy_snapshot is not None:
                self._restore_snapshot()
                rolled, poisoned = True, False
            # non-recoverable fatals (epsilon overspend) and a poisoned
            # round 0 with nothing to restore degrade to warnings below
        for a in to_warn:
            warnings.warn(
                f"[health] round {a.round_index} {a.check} "
                f"({a.severity}): {a.message}", RuntimeWarning)
        return rolled, not poisoned, abort_alert

    def _g_updates(self, d_avg, batches: int) -> List[float]:
        """Server G update against the averaged D (never touches real data)."""
        st = self.state
        g_losses = []
        with span("g_update"):
            for _ in range(batches):
                st.g_params, st.g_opt, gl = self._g_step(
                    st.g_params, st.g_opt, d_avg, self._z(self.batch_size))
                g_losses.append(float(gl))
        return g_losses

    def _record(self, metrics: Dict[str, float]) -> Dict[str, float]:
        for k, v in metrics.items():
            self.state.history.setdefault(k, []).append(v)
        return metrics

    # ------------------------------------------------------------------
    @fp32_convolutions()
    def train_epoch(self, batches_per_client: int = 24,
                    backend: Optional[str] = None) -> Dict[str, float]:
        """One FL round on the federation engine (``cfg.fed``: sync, flat
        or hierarchical, or async scheduling; the uplink codec; the server
        reduce).  ``backend`` (default ``cfg.fed.backend``) selects how the
        client program runs: ``"loop"`` (per-client steps), ``"vectorized"``
        (one stacked step a batch per split signature) or ``"auto"`` (a
        timed probe of both on the first round picks one for the trainer's
        life, ``_resolve_auto_backend``).  Privacy composes: DP-SGD inside
        the step, uplink DP as the engine's pre-codec stage.  Optimizer
        state commits only for clients whose update landed
        (``RoundReport.opt_states``) — dropped stragglers leave no
        trace.

        The control plane wraps the round: under ``mode='adaptive'`` the
        controller suite turns the ``RoundFeedback`` history into knob
        decisions BEFORE the round; a new ``RoundFeedback`` is appended
        AFTER it either way (``self.feedback``).  The watchtower closes
        the round: monitors scan the aggregated state and the feedback,
        and the policy acts — ``record``/``warn`` observe, ``abort``
        raises :class:`~repro_torch.obs.health.HealthAbort`, ``rollback``
        restores the last healthy state.  With the recorder's ``digests``
        sink on, the round also commits a digest of the post-action global
        state (``digests.jsonl``).

        The round is the program's ``round`` host span
        (``repro_torch/obs/trace.py``): commit, g_update and feedback here,
        engine and what it runs in ``fed/``.  They record under an active
        tracer; the recorder makes its own active for the round when its
        ``trace_clock`` is ``wall`` or ``both``."""
        rec = nullcontext() if self.recorder is None \
            else self.recorder.tracing()
        with rec, span("round", index=self.state.step):
            return self._round(batches_per_client, backend)

    def _round(self, batches_per_client: int, backend: Optional[str]
               ) -> Dict[str, float]:
        backend = backend or self.cfg.fed.backend
        st = self.state
        if self.monitor is not None \
                and self.cfg.obs.health.policy == "rollback" \
                and self._healthy_snapshot is None:
            # round-start state = the last known-healthy state a poisoned
            # round 0 can fall back to
            self._healthy_snapshot = self._snapshot_state()
        if self.recorder is not None and not self._manifest_written:
            leaf_sizes, hint = self._controller_inputs(batches_per_client)
            self.recorder.set_manifest(self.cfg, leaf_sizes=leaf_sizes,
                                       steps_per_round_hint=hint)
            self._manifest_written = True
            if self.cfg.obs.profile_kernels and not self._profiled:
                self.recorder.write_profile(
                    profile_engine_kernels(self.cfg, device=self.device))
                self._profiled = True
        if self._adaptive():
            self._apply_knobs(self._ensure_controllers(batches_per_client)(
                self.feedback, self.knobs))
        eng = self._ensure_engine(batches_per_client)
        probe_us: Dict[str, float] = {}
        if backend == "auto":
            backend, probe_us = self._resolve_auto_backend(
                batches_per_client)
        if self._adaptive():
            eng.set_codec(self.knobs.codec, self.knobs.topk_frac)
            eng.set_deadline(self.knobs.deadline_s)
        acct_steps_before = self.accountant.steps if self.accountant else 0
        batch_b = fake_batch_bytes(
            self.batch_size,
            (self.c.image_size, self.c.image_size, self.c.channels))
        # downlink payload priced per client: a longer local_steps
        # schedule downloads proportionally more fake batches
        down_by_client = {cid: spec.local_steps * batch_b
                          for cid, spec in eng.specs.items()}
        # measured LAN payload of one local round per split-executed client
        lan_by_client = {cid: spec.local_steps * self._split_step_bytes[cid]
                         for cid, spec in eng.specs.items()
                         if cid in self._split_step_bytes}
        # the global D: every replica equals the last broadcast average
        global_d = st.d_params[self._active_clients()[0]]
        rep = eng.run_round(global_d,
                            self._bind_round(batches_per_client, backend),
                            down_bytes=batches_per_client * batch_b,
                            down_bytes_by_client=down_by_client,
                            lan_bytes_by_client=lan_by_client,
                            timeline_by_client=self._trace_timelines or None)
        d_avg = rep.global_params
        with span("commit"):
            for cid, opt in rep.opt_states.items():
                st.d_opt[cid] = opt
            for cid in self.client_ids:
                st.d_params[cid] = tree_map(torch.clone, d_avg)

        d_losses = [l for _, info in rep.client_infos
                    for l in info["losses"]]
        g_losses = self._g_updates(d_avg, batches_per_client)
        st.step += 1
        with span("feedback"):
            if self.accountant is not None:
                # adaptive runs account each round at the sigma the controller
                # bound; frozen runs use the constructor's
                sigma_arg = self.knobs.sigma if self._adaptive() else None
                if self.cfg.privacy.mode == "dp_sgd":
                    # one Gaussian-mechanism release per EXECUTED DP batch,
                    # late-but-executed straggler work included
                    self.accountant.step(sum(info.get("steps", 0)
                                             for _, info in rep.client_infos),
                                         noise_multiplier=sigma_arg)
                else:
                    # one release per executed uplink
                    self.accountant.step(len(rep.client_infos),
                                         noise_multiplier=sigma_arg)
            metrics = {
                "d_loss": (float(np.mean(d_losses)) if d_losses
                           else float("nan")),
                "g_loss": float(np.mean(g_losses)),
                "num_clients": float(len(rep.participated)),
                "round_time_s": rep.round_time_s,
                "clock_s": rep.clock_s,
                "up_mbytes": rep.traffic.total_up / 1e6,
                "down_mbytes": rep.traffic.total_down / 1e6,
                "stragglers": float(len(rep.stragglers)),
                "mean_staleness": rep.mean_staleness,
            }
            if rep.traffic.total_edge:
                metrics["edge_mbytes"] = rep.traffic.total_edge / 1e6
            loads: Dict[str, float] = {}
            if self.split_execs:
                # executed split: measured boundary bytes that crossed the LAN
                # this round, and the compute load each device carried
                loads = self.device_load_report()
                metrics["lan_mbytes"] = rep.traffic.total_lan / 1e6
                metrics["max_device_load"] = max(loads.values())
                metrics["mean_device_load"] = float(np.mean(list(
                    loads.values())))
            if self.accountant is not None:
                metrics["dp_epsilon"] = self.accountant.epsilon(
                    self.cfg.privacy.delta)[0]
            cerrs = list(rep.codec_error.values())
            if cerrs:
                metrics["codec_error"] = float(np.mean(cerrs))
            # the round's measurements as ONE typed record — what the
            # controllers consume next round (and what frozen runs still log)
            probe: Dict[str, Tuple[float, ...]] = {}
            if self._adaptive() and "split" in self.cfg.control.controllers \
                    and self.split_execs:
                probe = self._probe_boundary_dcor()
            fb = RoundFeedback(
                round_index=st.step - 1,
                backend=backend,
                codec=eng.codec_name,
                sigma=self.knobs.sigma,
                deadline_s=eng.deadline_s,
                split_strategy=self.knobs.split_strategy,
                up_bytes=int(rep.traffic.total_up),
                down_bytes=int(rep.traffic.total_down),
                lan_bytes=int(rep.traffic.total_lan),
                codec_error=float(np.mean(cerrs)) if cerrs else float("nan"),
                uplink_bps=float(self.cfg.fed.uplink_bps),
                round_time_s=float(rep.round_time_s),
                clock_s=float(rep.clock_s),
                client_finish_s=dict(rep.finish_s),
                num_clients=len(rep.participated),
                stragglers=len(rep.stragglers),
                d_loss=metrics["d_loss"],
                g_loss=metrics["g_loss"],
                dp_epsilon=metrics.get("dp_epsilon", float("nan")),
                dp_steps=(self.accountant.steps - acct_steps_before
                          if self.accountant else 0),
                device_loads=loads,
                boundary_dcor=probe,
                pipeline_microbatches=self._pipeline_k(),
                pipeline_speedup=self._pipeline_speedup,
                backend_probe_us=probe_us,
                edge_bytes=int(rep.traffic.total_edge),
                cohorts=int(self.cfg.fed.hierarchy_cohorts),
                shards=self._num_shards(backend))
            self.feedback.append(fb)

            # watchtower: check the round, act per policy, THEN digest the
            # committed state — so a rolled-back round's committed digest
            # equals the last healthy one while RoundReport.global_digest
            # (stamped before any action by the engine's digester) keeps what
            # the poisoned aggregate actually was
            alerts: List[HealthAlert] = []
            rolled_back, state_healthy, abort_alert = False, True, None
            if self.monitor is not None:
                alerts = self.monitor.check_round(fb, params=d_avg,
                                                  update_base=global_d)
                self.health_alerts.extend(alerts)
                if alerts:
                    rolled_back, state_healthy, abort_alert = \
                        self._apply_health_policy(alerts)
            digest: Optional[RoundDigest] = None
            if self.recorder is not None and self.recorder.wants("digests"):
                digest = state_digest(
                    st.d_params[self._active_clients()[0]], st.d_opt,
                    st.g_params, st.g_opt, round_index=fb.round_index,
                    aggregated=rep.global_digest or "",
                    rolled_back=rolled_back)
            if self.recorder is not None:
                # feedback + the knobs in force during this round (the
                # decision the offline replay must reproduce), then re-export
                # the trace so a killed run still leaves a loadable file
                self.recorder.on_round(fb, self.knobs)
                for a in alerts:
                    self.recorder.on_alert(a)
                if digest is not None:
                    self.recorder.on_digest(digest)
                self.recorder.flush()
            if self.monitor is not None \
                    and self.cfg.obs.health.policy == "rollback" \
                    and state_healthy:
                # refresh the rollback point: the state now committed is
                # healthy (genuinely, or because it was just restored)
                self._healthy_snapshot = self._snapshot_state()
            if abort_alert is not None:
                raise HealthAbort(abort_alert)
            return self._record(metrics)

    # ------------------------------------------------------------------
    @fp32_convolutions()
    def train_epoch_sequential(self, batches_per_client: int = 24
                               ) -> Dict[str, float]:
        """The sequential client loop, kept as the numeric reference: the
        engine's sync round with the host FedAvg matches it bit-for-bit.
        Uplink DP is applied to each client's round delta as the engine's
        pre-codec stage would, so the reference also covers
        ``privacy.mode='uplink'`` with ``codec='none'``; DP-SGD draws the
        noise the engine's loop draws (same key path).

        This loop trains the MONOLITHIC D, which equals the split-executed
        step only under the identity boundary stage; any other stage trains
        a different model, so that combination is refused."""
        if any(s.name != "identity" for ex in self.split_execs.values()
               for s in ex.stages):
            raise ValueError(
                "train_epoch_sequential is the unsplit/identity-stage "
                f"reference; boundary_stage="
                f"{self.cfg.split.boundary_stage!r} trains a different "
                "(staged) model — use train_epoch")
        st = self.state
        d_losses = []
        active = self._active_clients()
        round_key = self._round_key()
        for i, cid in enumerate(active):
            start = st.d_params[cid]
            dp, do = start, st.d_opt[cid]
            for b in range(batches_per_client):
                real = self._sample_real(cid, self.batch_size)
                fake = self._gen(st.g_params, self._z(self.batch_size))
                # server ships fakes; client never shares `real`
                key = (None if round_key is None
                       else keys.fold_in(round_key, 0, i, 0, b))
                dp, do, dl = self._d_update(dp, do, real, fake, key)
                d_losses.append(float(dl))
            if self._uplink_stage is not None:
                # the engine's pre-codec uplink path with the identity
                # codec: clip+noise the fp32 round delta, then rebase
                dp = apply_delta(
                    start, self._uplink_stage(cid, delta_tree(dp, start)))
            st.d_params[cid], st.d_opt[cid] = dp, do

        if self.accountant is not None and self.cfg.privacy.mode == "uplink":
            self.accountant.step(len(active))

        # FedAvg over client discriminators (weighted by examples)
        weights = ([len(self.client_data[cid]) for cid in active]
                   if self.cfg.fsl.weighted_average else None)
        d_avg = fedavg([st.d_params[cid] for cid in active], weights)
        for cid in self.client_ids:
            st.d_params[cid] = tree_map(torch.clone, d_avg)

        g_losses = self._g_updates(d_avg, batches_per_client)
        st.step += 1
        metrics = {"d_loss": float(np.mean(d_losses)),
                   "g_loss": float(np.mean(g_losses)),
                   "num_clients": float(len(active))}
        if self.accountant is not None:
            metrics["dp_epsilon"] = self.accountant.epsilon(
                self.cfg.privacy.delta)[0]
        return self._record(metrics)

    def device_load_report(self) -> Dict[str, float]:
        """Compute units each device carries under the current plans
        (device ids are globally unique: ``c<i>_d<j>``)."""
        loads: Dict[str, float] = {}
        for cid in self._active_clients():
            if cid in self.plans:
                for dev, load in self.plans[cid].device_loads().items():
                    loads[dev] = loads.get(dev, 0.0) + load
        return loads or {"unsplit": 0.0}

    @fp32_convolutions()
    def generate(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` images (n, H, W, C) from G, with z drawn from a
        ``torch.Generator`` seeded ``seed`` (not the JAX key stream)."""
        z = torch.randn((n, self.c.latent_dim),
                        generator=torch.Generator().manual_seed(seed))
        return self._gen(self.state.g_params,
                         z.to(self.device)).cpu().numpy()
