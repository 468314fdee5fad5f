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
    measured per-boundary payloads.  Disabled, the plan only prices the
    round and the monolithic D trains, as in the paper's Colab runs.

Losses: non-saturating DCGAN BCE.
    L_D = BCE(D(x_real), 1) + BCE(D(G(z)), 0)
    L_G = BCE(D(G(z)), 1)

``train_epoch`` runs one federation-engine round per epoch (sync barrier,
flat or through the edge hierarchy, or the async FedAsync/FedBuff modes;
loop backend; any uplink codec; the decode, stream or batched server
reduce, which ``fed.kernel_aggregation`` sends through the fedavg and
agg_fuse CUDA kernels).  Privacy (``cfg.privacy``) is
DP-SGD inside the local step (the dp_clip CUDA kernel with
``privacy.use_kernel``) or the pre-codec uplink DP stage in the engine,
with an RDP accountant either way.  ``train_epoch_sequential`` keeps the
plain sequential loop; with the host FedAvg the two are bit-for-bit
identical (pinned in the tests).

Options of the JAX trainer that need modules not ported yet raise
``NotImplementedError`` naming their ROADMAP item (:func:`check_ported`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import keys
from repro_torch.config import RunConfig
from repro_torch.core.devices import make_pool
from repro_torch.core.fedavg import fedavg
from repro_torch.core.selection import plan_all_clients
from repro_torch.core.simulate import plan_epoch_time
from repro_torch.core.split import (SplitExecution, SplitPlan,
                                    make_boundary_stage)
from repro_torch.device import resolve_device
from repro_torch.fed.engine import ClientSpec, FederationEngine
from repro_torch.fed.hierarchy import assign_cohorts
from repro_torch.fed.programs import ClientHyper, LocalProgram, RoundExecutor
from repro_torch.fed.transport import apply_delta, delta_tree, fake_batch_bytes
from repro_torch.models.dcgan import (disc_apply, disc_apply_layer, disc_init,
                                      disc_layer_costs, disc_layer_names,
                                      gen_apply, gen_init)
from repro_torch.optim import make_optimizer
from repro_torch.privacy.defenses import (RDPAccountant, make_dp_d_step,
                                          make_uplink_stage)
from repro_torch.tree import tree_map, value_and_grad


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


# (is the option set?, what it is, the ROADMAP Queue A item that ports it)
_UNPORTED = (
    (lambda cfg: cfg.fed.backend != "loop", "fed.backend other than 'loop'",
     "item 7 (vectorized backend)"),
    (lambda cfg: cfg.fed.shard_clients, "fed.shard_clients",
     "item 7 (client mesh)"),
    (lambda cfg: cfg.split.enabled and cfg.split.pipeline_microbatches > 1,
     "split.pipeline_microbatches > 1", "item 12 (pipelined split)"),
    (lambda cfg: (cfg.split.enabled and cfg.privacy.enabled
                  and cfg.privacy.mode == "dp_sgd"),
     "privacy.mode='dp_sgd' with split.enabled",
     "item 13 (DP-SGD with the executed split)"),
    (lambda cfg: cfg.control.mode == "adaptive", "control.mode='adaptive'",
     "item 8 (control plane)"),
    (lambda cfg: cfg.obs.enabled, "obs.enabled", "item 8 (flight recorder)"),
    (lambda cfg: cfg.obs.health.enabled, "obs.health.enabled",
     "item 8 (health monitors)"),
)


def check_ported(cfg: RunConfig) -> None:
    """Raise ``NotImplementedError`` for the first option ``cfg`` sets that
    needs a module not ported yet."""
    for is_set, what, item in _UNPORTED:
        if is_set(cfg):
            raise NotImplementedError(
                f"{what} is not ported to repro_torch yet "
                f"(ROADMAP Queue A {item})")


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
        check_ported(cfg)
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
        # split planning.  cfg.split.enabled compiles each plan into the
        # executed local step (core/split.SplitExecution); otherwise the
        # plan only prices the round and training runs the monolithic D.
        self.pool = make_pool(cfg.fsl.heterogeneity, cfg.fsl.num_clients,
                              cfg.fsl.devices_per_client, cfg.fsl.seed)
        costs = disc_layer_costs(self.c)
        self._layers = [(n, costs[n]) for n in disc_layer_names(self.c)]
        self.plans: Dict[str, SplitPlan] = plan_all_clients(
            self.pool, self._layers, cfg.split.strategy or cfg.fsl.selection,
            cfg.fsl.seed)
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

    def _build_split_programs(self):
        """Build the split executions and the client program from the
        plans.  Each feasible plan becomes a staged local step whose
        boundary tensors pass the configured stage; its measured per-step
        LAN bytes are kept for pricing."""
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
            for cid, plan in self.plans.items():
                ex = SplitExecution(plan, apply_layer, tails, stage=stage)
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

    def _ensure_engine(self, batches_per_client: int) -> FederationEngine:
        """(Re)build the engine when the local-round length changes — client
        compute times are priced per round.  Rebuilding resets the virtual
        clock, not any training state."""
        if self.engine is not None \
                and self._engine_batches == batches_per_client:
            return self.engine
        by_id = {cl.client_id: cl for cl in self.pool}
        specs = []
        for cid in self._active_clients():
            steps = self._client_steps(cid, batches_per_client)
            if cid in self.plans and cid in by_id:
                # split-executed clients are priced from the MEASURED
                # per-boundary bytes their step ships; unsplit training
                # keeps the analytic hop constant
                ct = plan_epoch_time(
                    self.plans[cid], by_id[cid], batches_per_epoch=steps,
                    lan_latency_s=self._lan_latency_s(),
                    boundary_bytes=self._split_hop_events.get(cid),
                    lan_bandwidth_bps=self.cfg.split.lan_bandwidth_bps)
            else:
                ct = 0.0
            specs.append(ClientSpec(
                cid, float(len(self.client_data[cid])), ct,
                lr_scale=float(self.cfg.fed.client_lr_scales.get(cid, 1.0)),
                local_steps=steps))
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
        self._engine_batches = batches_per_client
        return self.engine

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

    def _bind_round(self, batches_per_client: int, backend: str
                    ) -> RoundExecutor:
        """Bind the client program to this round: data sampling, opt-state
        lookup, per-client hyperparameter schedules (from the engine's
        ``ClientSpec``s, built in ``_ensure_engine``) and the round's noise
        key."""
        hyper = {cid: ClientHyper(lr_scale=spec.lr_scale,
                                  local_steps=spec.local_steps)
                 for cid, spec in self.engine.specs.items()}
        return RoundExecutor(
            self.program, backend=backend,
            sample=self._sample_round_batches,
            opt_lookup=lambda cid: self.state.d_opt[cid],
            default_steps=batches_per_client, hyper=hyper,
            round_key=self._round_key(), cohort_of=self._cohort_of)

    def _g_updates(self, d_avg, batches: int) -> List[float]:
        """Server G update against the averaged D (never touches real data)."""
        st = self.state
        g_losses = []
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
    def train_epoch(self, batches_per_client: int = 24,
                    backend: Optional[str] = None) -> Dict[str, float]:
        """One FL round on the federation engine (``cfg.fed``: sync, flat
        or hierarchical, or async scheduling; the uplink codec; the server
        reduce).  ``backend`` (default ``cfg.fed.backend``)
        selects how the client program runs; ``"loop"`` (per-client steps)
        is the one ported.  Privacy composes: DP-SGD inside the step, uplink
        DP as the engine's pre-codec stage.  Optimizer state commits only
        for clients whose update landed (``RoundReport.opt_states``) —
        dropped stragglers leave no trace."""
        backend = backend or self.cfg.fed.backend
        st = self.state
        eng = self._ensure_engine(batches_per_client)
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
                            lan_bytes_by_client=lan_by_client)
        d_avg = rep.global_params
        for cid, opt in rep.opt_states.items():
            st.d_opt[cid] = opt
        for cid in self.client_ids:
            st.d_params[cid] = tree_map(torch.clone, d_avg)

        d_losses = [l for _, info in rep.client_infos
                    for l in info["losses"]]
        g_losses = self._g_updates(d_avg, batches_per_client)
        st.step += 1
        if self.accountant is not None:
            if self.cfg.privacy.mode == "dp_sgd":
                # one Gaussian-mechanism release per EXECUTED DP batch,
                # late-but-executed straggler work included
                self.accountant.step(sum(info.get("steps", 0)
                                         for _, info in rep.client_infos))
            else:
                # one release per executed uplink
                self.accountant.step(len(rep.client_infos))
        metrics = {
            "d_loss": float(np.mean(d_losses)) if d_losses else float("nan"),
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
        return self._record(metrics)

    # ------------------------------------------------------------------
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

    def generate(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` images (n, H, W, C) from G, with z drawn from a
        ``torch.Generator`` seeded ``seed`` (not the JAX key stream)."""
        z = torch.randn((n, self.c.latent_dim),
                        generator=torch.Generator().manual_seed(seed))
        return self._gen(self.state.g_params,
                         z.to(self.device)).cpu().numpy()
