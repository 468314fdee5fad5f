"""Configuration system for the FSL-GAN framework.

A copy of ``repro/config/base.py``: the port reads the same configuration
objects, field for field, so one dotted override means the same thing in
both packages.  Every option has a ported module behind it; the JAX-only
switches (``*.kernel_interpret``, ``split.pipeline_scan``) are read and
ignored.

Plain dataclasses (no external deps) with:
  - nested to_dict / from_dict round-tripping,
  - dotted-path CLI overrides (``--set model.d_model=512``),
  - validation hooks,
  - derived-quantity helpers (param counts, per-family feature flags).

Every assigned architecture is expressed as a :class:`RunConfig`; reduced
"smoke" variants are produced by :func:`reduce_for_smoke`.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------

DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"
DCGAN = "dcgan"

FAMILIES = (DENSE, MOE, SSM, HYBRID, VLM, AUDIO, DCGAN)

# Attention kinds
ATTN_FULL = "full"            # causal full attention
ATTN_SLIDING = "sliding"      # sliding-window causal attention
ATTN_NONE = "none"            # attention-free (e.g. RWKV)

# ---------------------------------------------------------------------------
# Valid knob names — the single source of truth.
#
# Runtime factories (fed/transport.make_codec, core/split.make_boundary_stage,
# core/selection.STRATEGIES, fed/programs.BACKENDS) key off these same names;
# validating HERE means a typo'd config fails at construction with the list of
# valid options instead of deep inside a jitted program.
# ---------------------------------------------------------------------------

CODECS = ("none", "fp16", "int8", "topk")
# "+"-composed names chain stages in order (codec round-trip, then
# clip+noise); core/split.make_boundary_stage fuses the fusable ones
# (fp16+dp, int8+dp) into the single-traversal kernels/boundary_fuse op.
BOUNDARY_STAGES = ("identity", "fp16", "int8", "topk", "dp",
                   "fp16+dp", "int8+dp", "topk+dp")
SELECTION_STRATEGIES = ("random_single", "random_multi", "sorted_single",
                        "sorted_multi")
FED_MODES = ("sync", "fedasync", "fedbuff")
# "auto" probes loop vs vectorized dispatch once on the first round and
# pins the faster one (core/gan.FSLGANTrainer); fed/programs.BACKENDS
# stays ("loop", "vectorized") — the executor never sees "auto".
FED_BACKENDS = ("loop", "vectorized", "auto")
# server-side reduce over landed uplinks (fed/engine + fed/aggregate):
# "decode" stages one decoded fp32 tree per client then FedAvgs (the
# bit-exact reference); "stream" folds each WIRE payload into one fp32
# accumulator via kernels/agg_fuse as it lands (O(1) server memory);
# "batched" stacks wire payloads per leaf and reduces them in one fused
# call (vmapped decode for top-k), sharded when fed.shard_clients is on.
SERVER_REDUCES = ("decode", "stream", "batched")
PRIVACY_MODES = ("dp_sgd", "uplink")
CONTROL_MODES = ("frozen", "adaptive")
CONTROLLERS = ("codec", "sigma", "split", "deadline")
OBS_TRACE_CLOCKS = ("virtual", "wall", "both")
OBS_SINKS = ("trace", "metrics", "feedback", "alerts", "digests")
# what a fatal health verdict does to the run (obs/health.py)
HEALTH_POLICIES = ("record", "warn", "abort", "rollback")


def _check_name(section: str, field_name: str, value: str,
                valid: Tuple[str, ...], *, aliases: Tuple[str, ...] = ()
                ) -> None:
    """Construction-time name validation with the valid options spelled out."""
    if value in valid or value in aliases:
        return
    raise ValueError(
        f"{section}.{field_name}={value!r} is not a valid option; "
        f"expected one of {list(valid)}")


@dataclass
class MoEConfig:
    """Mixture-of-Experts settings (DeepSeek-V2-Lite, OLMoE)."""
    num_experts: int = 0                  # routed experts
    num_shared_experts: int = 0           # always-on experts (DeepSeek)
    top_k: int = 0
    d_ff_expert: int = 0                  # per-expert hidden dim
    router_aux_coef: float = 0.01         # load-balance loss coefficient
    router_jitter: float = 0.0
    capacity_factor: float = 0.0          # 0 => dropless (dense one-hot dispatch)

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 0                 # compressed KV latent dim (512 for V2-Lite)
    q_lora_rank: int = 0                  # 0 => full-rank queries (V2-Lite)
    rope_head_dim: int = 64               # decoupled rope sub-dim per head
    v_head_dim: int = 0                   # value head dim (defaults to head_dim)

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclass
class RWKVConfig:
    """RWKV-6 ("Finch") settings."""
    head_dim: int = 64
    decay_lora: int = 64                  # lora rank of data-dependent decay
    token_shift_lora: int = 32            # lora rank of ddlerp token-shift
    gate_lora: int = 64

    @property
    def enabled(self) -> bool:
        return self.head_dim > 0


@dataclass
class RGLRUConfig:
    """RecurrentGemma RG-LRU + local-attention hybrid settings."""
    lru_width: int = 0                    # recurrent width (d_model if 0)
    conv_width: int = 4                   # temporal conv1d width in recurrent block
    window: int = 2048                    # local-attention window
    pattern: Tuple[str, ...] = ()         # e.g. ("rglru","rglru","attn") repeated

    @property
    def enabled(self) -> bool:
        return bool(self.pattern)


@dataclass
class EncDecConfig:
    """Encoder-decoder (whisper) settings; the conv/mel frontend is a stub."""
    encoder_layers: int = 0
    encoder_seq: int = 1500               # whisper: 30 s -> 1500 frames after conv
    max_target_positions: int = 448

    @property
    def enabled(self) -> bool:
        return self.encoder_layers > 0


@dataclass
class DCGANConfig:
    """The paper's own model: DCGAN with 3 conv blocks (Radford et al. 2016)."""
    image_size: int = 28
    channels: int = 1
    latent_dim: int = 100
    base_filters: int = 64
    conv_blocks: int = 3

    @property
    def enabled(self) -> bool:
        return self.conv_blocks > 0


@dataclass
class ModelConfig:
    name: str = "unnamed"
    family: str = DENSE
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                     # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    max_seq_len: int = 8192
    # flags
    attention: str = ATTN_FULL
    sliding_window: int = 0               # used when attention == ATTN_SLIDING
    qk_norm: bool = False                 # Qwen3
    qkv_bias: bool = False                # Qwen2
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"                     # mlp activation (silu => SwiGLU)
    # family sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    rwkv: RWKVConfig = field(default_factory=RWKVConfig)
    rglru: RGLRUConfig = field(default_factory=RGLRUConfig)
    encdec: EncDecConfig = field(default_factory=EncDecConfig)
    dcgan: DCGANConfig = field(default_factory=DCGANConfig)
    # provenance
    source: str = ""                      # citation bracket from the assignment

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.num_heads > 0:
            self.head_dim = self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def gqa_groups(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count N (used for MODEL_FLOPS = 6*N*D)."""
        if self.family == DCGAN:
            return _dcgan_params(self.dcgan)
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        # attention
        if self.mla.enabled:
            rk = self.mla.kv_lora_rank
            rh = self.mla.rope_head_dim
            vh = self.mla.v_head_dim or self.head_dim
            nh = self.num_heads
            qd = nh * (self.head_dim + rh)
            per_layer += d * qd                       # q proj (full rank, V2-Lite)
            per_layer += d * (rk + rh)                # compressed kv + rope k
            per_layer += rk * nh * (self.head_dim + vh)  # kv up-proj
            per_layer += nh * vh * d                  # o proj
        elif self.family == SSM:
            # RWKV-6 time-mix: r,k,v,g,o projections + small loras + decay
            per_layer += 5 * d * d
            per_layer += d * (self.rwkv.decay_lora * 2)
            per_layer += 5 * d * self.rwkv.token_shift_lora * 2
        else:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
        # mlp
        if self.moe.enabled:
            e = self.moe
            ff = e.d_ff_expert
            per_layer += (e.num_experts + e.num_shared_experts) * 3 * d * ff
            per_layer += d * e.num_experts            # router
        elif self.family == SSM:
            per_layer += 2 * d * self.d_ff            # rwkv channel-mix (k,v) + r gate
            per_layer += d * d
        else:
            mult = 3 if self.act == "silu" else 2     # swiglu has gate+up+down
            per_layer += mult * d * self.d_ff
        # rglru hybrid replaces some attn layers with LRU blocks
        if self.rglru.enabled:
            lw = self.rglru.lru_width or d
            n_rec = sum(1 for p in self._layer_pattern() if p == "rglru")
            n_att = L - n_rec
            att_params = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            rec_params = 2 * d * lw + lw * d + 2 * lw * self.rglru.conv_width + 2 * lw
            per_layer = 0  # recompute fully below
            mlp = 3 * d * self.d_ff
            total_layers = n_att * (att_params + mlp) + n_rec * (rec_params + mlp)
            norms = L * 2 * d + d
            return emb + total_layers + norms
        norms = L * 2 * d + d
        total = emb + L * per_layer + norms
        if self.encdec.enabled:
            # encoder layers (full self-attn + mlp) + decoder cross-attn
            enc_l = (d * self.q_dim * 2 + 2 * d * self.kv_dim + 2 * d * self.d_ff)
            total += self.encdec.encoder_layers * enc_l
            total += L * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts count)."""
        if not self.moe.enabled:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        e = self.moe
        inactive = (e.num_experts - e.top_k) * 3 * d * e.d_ff_expert * L
        return int(self.param_count() - inactive)

    def _layer_pattern(self) -> List[str]:
        if not self.rglru.enabled:
            return ["attn"] * self.num_layers
        pat = list(self.rglru.pattern)
        out: List[str] = []
        while len(out) < self.num_layers:
            out.extend(pat)
        return out[: self.num_layers]


def _dcgan_params(c: DCGANConfig) -> int:
    # generator: project latent -> (f*4, 7, 7) then 2 deconv blocks -> image
    f = c.base_filters
    g = c.latent_dim * f * 4 * 7 * 7 + (f * 4) * (f * 2) * 25 + (f * 2) * f * 25 + f * c.channels * 25
    # discriminator: conv_blocks convs + classifier
    d = c.channels * f * 25 + f * f * 2 * 25 + f * 2 * f * 4 * 25 + f * 4 * 7 * 7
    return int(g + d)


# ---------------------------------------------------------------------------
# Parallelism / runtime
# ---------------------------------------------------------------------------

@dataclass
class ParallelConfig:
    # mesh
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: str = "pod"
    # strategies
    fsdp: bool = True                     # shard params over `data` too
    tensor_parallel: bool = True          # shard heads/ffn over `model`
    expert_parallel: bool = True          # shard experts over `model`
    sequence_parallel: bool = True        # shard residuals over `model` on seq dim
    # training memory knobs
    microbatches: int = 1                 # gradient-accumulation steps
    remat: str = "full"                   # "none" | "full" | "dots"
    scan_layers: bool = True              # False => unrolled (probe mode)
    unroll_microbatches: bool = False     # True => python loop (probe mode)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    accum_dtype: str = "float32"          # gradient-accumulation dtype
    cache_dtype: str = "bfloat16"         # KV/decode-state dtype
    # attention kernel dispatch
    use_flash_kernel: bool = False        # Pallas kernels opt-in (tests turn on)


@dataclass
class OptimConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    schedule: str = "constant"            # "constant" | "cosine" | "linear"
    warmup_steps: int = 0
    total_steps: int = 1000
    state_dtype: str = ""                 # "" => same as param dtype


@dataclass
class FSLConfig:
    """Paper knobs: clients, devices-per-client, selection, averaging cadence."""
    num_clients: int = 5
    devices_per_client: int = 4
    selection: str = "sorted_multi"       # random_single|random_multi|sorted_single|sorted_multi
    local_steps: int = 1                  # FedAvg cadence (1 == per-step sync)
    lan_latency_s: float = 0.050          # paper: 50 ms per LAN hop
    weighted_average: bool = True         # weight FedAvg by client example counts
    heterogeneity: str = "paper"          # device-pool preset (see core/devices.py)
    seed: int = 0

    def __post_init__(self) -> None:
        _check_name("fsl", "selection", self.selection, SELECTION_STRATEGIES)


@dataclass
class FedConfig:
    """Federation runtime knobs (fed/ subsystem): what crosses the wire,
    how it is compressed, and how/when the server aggregates.

    ``mode='sync'`` with ``codec='none'``, ``backend='loop'``, full
    availability and no deadline reproduces the paper's sequential
    simulation bit-for-bit (pinned test).
    """
    mode: str = "sync"                 # sync | fedasync | fedbuff
    # client-program backend (fed/programs.py): how the local round runs.
    # "loop" = per-client steps (the bit-exact reference); "vectorized" =
    # one stacked step a batch for the clients of a split signature
    # (torch.func.vmap over clients); "auto" = whichever a timed probe on
    # the first round finds faster.  Orthogonal to scheduling and privacy
    # — every mode x backend x privacy cell is supported.
    backend: str = "loop"              # loop | vectorized | auto
    # per-client local-round schedules, keyed by client id; unlisted
    # clients use the defaults (lr_scale 1.0 / the round's
    # batches_per_client).  Threaded through both backends.
    client_lr_scales: Dict[str, float] = field(default_factory=dict)
    client_local_steps: Dict[str, int] = field(default_factory=dict)
    # uplink compression (discriminator params / deltas)
    codec: str = "none"                # none | fp16 | int8 | topk
    topk_frac: float = 0.01            # fraction of entries topk keeps
    error_feedback: bool = True        # topk residual carry-over
    # transport (WAN between server and clients; LAN inside a client is
    # priced by core/simulate.py)
    uplink_bps: float = 10e6           # client -> server
    downlink_bps: float = 50e6         # server -> client
    wan_latency_s: float = 0.050
    # scheduling
    deadline_s: float = 0.0            # sync: drop updates landing later (0=off)
    availability: float = 1.0          # per-round client up-probability
    availability_seed: int = 0
    async_cycles: int = 1              # local rounds per client per epoch (async)
    # async aggregation
    fedasync_alpha: float = 0.6        # server mixing rate
    staleness_power: float = 0.5       # alpha_t = alpha * (1+staleness)^-power
    buffer_size: int = 2               # fedbuff aggregation threshold K
    # aggregation hot path
    kernel_aggregation: bool = False   # use the fedavg Pallas kernel
    kernel_interpret: bool = False     # Pallas interpret mode (CPU tests)
    # server reduce strategy (SERVER_REDUCES above).  "decode" is the
    # bit-exact staging reference; "stream"/"batched" aggregate in the
    # compressed domain (pinned vs "decode" at fma-level tolerance —
    # mean(base + d_c) reassociates vs base + mean(d_c) in float).
    server_reduce: str = "decode"
    # population scale: cut the vectorized backend's stacked client axis
    # over a `clients` device mesh (launch/mesh.make_client_mesh +
    # sharding/specs.client_chunks) when the host has more than one card.
    # Off (default), or one card: every dispatch on the trainer's device.
    shard_clients: bool = False
    # two-tier aggregation: >= 2 groups sync-round clients into that many
    # edge cohorts, each pre-reducing its clients' updates (the fedavg
    # kernel when kernel_aggregation) BEFORE the WAN hop — only cohort
    # aggregates cross the WAN.  0/1 = flat FedAvg (bit-exact default).
    hierarchy_cohorts: int = 0
    # the client -> edge-aggregator link (LAN/MAN: faster + nearer than
    # the WAN); the WAN LinkModels above then price only edge -> server
    edge_uplink_bps: float = 200e6
    edge_latency_s: float = 0.005

    def __post_init__(self) -> None:
        _check_name("fed", "mode", self.mode, FED_MODES)
        _check_name("fed", "backend", self.backend, FED_BACKENDS)
        _check_name("fed", "codec", self.codec, CODECS,
                    aliases=("", "identity"))
        _check_name("fed", "server_reduce", self.server_reduce,
                    SERVER_REDUCES)
        if self.hierarchy_cohorts < 0:
            raise ValueError(
                f"fed.hierarchy_cohorts must be >= 0, got "
                f"{self.hierarchy_cohorts}")
        if self.edge_uplink_bps <= 0.0:
            raise ValueError(
                f"fed.edge_uplink_bps must be > 0, got "
                f"{self.edge_uplink_bps}")


@dataclass
class SplitConfig:
    """Executed split training (core/split.SplitExecution).

    ``enabled=False`` keeps the seed behavior: the SplitPlan only *prices*
    the round (analytic 50 ms hops) while training runs the monolithic D.
    ``enabled=True`` compiles each client's plan into the local step itself:
    forward/backward run device-segment by device-segment, every boundary
    tensor (activation fwd, activation-grad bwd) passes through the
    ``boundary_stage``, and round time + LAN bytes are priced from the
    measured per-boundary payloads instead of the hop constant.
    """
    enabled: bool = False
    # planner strategy override; "" uses cfg.fsl.selection
    strategy: str = ""
    # what crosses each LAN boundary: identity | fp16 | int8 | topk | dp
    boundary_stage: str = "identity"
    topk_frac: float = 0.01            # topk stage keep fraction
    stage_clip: float = 1.0            # dp stage: per-example L2 clip
    stage_sigma: float = 0.0           # dp stage: noise multiplier
    seed: int = 0                      # stage noise stream (dp stage)
    # LAN serialization rate for measured-bytes pricing (latency comes
    # from lan_latency_s below, falling back to cfg.fsl.lan_latency_s)
    lan_bandwidth_bps: float = 100e6
    # per-hop LAN latency override for the split chain; 0.0 inherits
    # cfg.fsl.lan_latency_s (the paper's 50 ms) end-to-end
    lan_latency_s: float = 0.0
    # 1F1B pipelined local step: micro-batches per batch (1 = sequential
    # executor, bit-exact with the pre-pipeline step; K > 1 overlaps
    # device segments, clamped per step to a divisor of the batch size)
    pipeline_microbatches: int = 1
    # compile the K-micro-batch loop as ONE lax.scan instead of K unrolled
    # staged chains (trace size O(1) in K; tolerance-pinned against the
    # unrolled loop).  Off (default) keeps the unrolled reference path.
    # The port ignores it: eager PyTorch has no trace to shrink.
    pipeline_scan: bool = False
    # fuse composed codec+dp stages into kernels/boundary_fuse (the
    # unfused ComposedBoundaryStage remains the pinned reference)
    fuse_boundary: bool = True
    use_kernel: bool = False           # Pallas path for the fused stage
    kernel_interpret: bool = False     # interpret mode (CPU) for it

    def __post_init__(self) -> None:
        _check_name("split", "boundary_stage", self.boundary_stage,
                    BOUNDARY_STAGES, aliases=("", "none"))
        if self.strategy:
            _check_name("split", "strategy", self.strategy,
                        SELECTION_STRATEGIES)
        if self.pipeline_microbatches < 1:
            raise ValueError(
                f"split.pipeline_microbatches must be >= 1, got "
                f"{self.pipeline_microbatches}")
        if self.lan_latency_s < 0.0:
            raise ValueError(
                f"split.lan_latency_s must be >= 0.0, got "
                f"{self.lan_latency_s}")


@dataclass
class PrivacyConfig:
    """Privacy subsystem knobs (privacy/ + kernels/dp_clip).

    ``enabled=False`` leaves every training path byte-identical to the
    non-private build (pinned test).  Two defense placements:

      * ``mode='dp_sgd'`` — per-example clip + Gaussian noise inside the
        device-side D step (Abadi et al. 2016), accounted per batch;
      * ``mode='uplink'`` — clip + noise the whole update delta once per
        round, as a pre-codec transport stage (fed/engine.py), accounted
        per round.
    """
    enabled: bool = False
    mode: str = "dp_sgd"               # dp_sgd | uplink
    clip_norm: float = 1.0             # per-example (dp_sgd) / per-delta L2
    noise_multiplier: float = 0.0      # sigma; noise stddev = sigma * clip
    delta: float = 1e-5                # accountant's delta target
    # accountant's per-step Poisson-sampling probability q.  The data
    # loader samples uniformly with replacement, so set q >= batch/|data|
    # to claim amplification honestly; the default 1.0 claims none.
    sample_rate: float = 1.0
    seed: int = 0                      # DP noise stream
    use_kernel: bool = False           # dp_clip Pallas kernel for clip+noise
    kernel_interpret: bool = False     # Pallas interpret mode (CPU tests)

    def __post_init__(self) -> None:
        _check_name("privacy", "mode", self.mode, PRIVACY_MODES)


@dataclass
class ControlConfig:
    """Closed-loop control plane (src/repro/control/): per-round controllers
    that turn measured :class:`~repro.control.RoundFeedback` into knob
    decisions between rounds.

    ``mode='frozen'`` (default) keeps every knob at its static config value
    — bit-exact with the pre-control build (pinned test); feedback is still
    emitted.  ``mode='adaptive'`` runs the controllers named in
    ``controllers`` each round:

      * ``codec``    — uplink codec from measured bandwidth + the observed
                       bytes-vs-delta-error frontier (fed/transport);
      * ``sigma``    — DP noise multiplier inverted from the RDP epsilon
                       curve to spend ``(epsilon_budget, privacy.delta)``
                       over ``horizon_rounds`` without ever exceeding it;
      * ``split``    — re-plan device selection / per-boundary stages when
                       measured load imbalance or boundary dCor drifts;
      * ``deadline`` — sync straggler deadline from the measured per-client
                       round-time distribution.
    """
    mode: str = "frozen"               # frozen | adaptive
    controllers: Tuple[str, ...] = ()  # subset of CONTROLLERS; () = none
    # codec controller
    codec_candidates: Tuple[str, ...] = ("topk", "int8", "fp16", "none")
    error_budget: float = 0.05         # max relative L2 delta error on uplink
    target_uplink_s: float = 0.0       # prefer lossless if it fits (0 = off)
    # sigma controller
    epsilon_budget: float = 0.0        # total epsilon to spend (0 = off)
    horizon_rounds: int = 0            # rounds the budget must cover
    sigma_min: float = 1e-2
    sigma_max: float = 1e4
    sigma_rel_change: float = 0.05     # ignore smaller rebinds (dp_sgd:
                                       # bounds per-round recompilation)
    # split controller
    imbalance_threshold: float = 2.0   # max/mean device load before replan
    dcor_threshold: float = 0.5        # boundary dCor above this gets noised
    replan_strategy: str = "sorted_multi"
    leaky_stage: str = "dp"            # stage assigned to leaky boundaries
    probe_batch: int = 16              # examples per boundary-dCor probe
    # deadline controller
    deadline_quantile: float = 0.9     # of the measured finish distribution
    deadline_slack: float = 1.25
    warmup_rounds: int = 1             # rounds of feedback before deciding

    def __post_init__(self) -> None:
        _check_name("control", "mode", self.mode, CONTROL_MODES)
        for c in self.controllers:
            _check_name("control", "controllers", c, CONTROLLERS)
        for name in self.codec_candidates:
            _check_name("control", "codec_candidates", name, CODECS)
        _check_name("control", "replan_strategy", self.replan_strategy,
                    SELECTION_STRATEGIES)
        _check_name("control", "leaky_stage", self.leaky_stage,
                    BOUNDARY_STAGES)


@dataclass
class HealthConfig:
    """Numeric-health monitors (obs/health.py): per-round verdicts over the
    freshly-aggregated global state and the ``RoundFeedback`` history.

    ``enabled=False`` (default) runs no monitor — nothing is scanned and
    training is untouched.  Enabled, every round is checked for non-finite
    global params / losses (fatal) and for heuristic drift (warn): D/G
    loss-ratio blowup, update-norm spikes, codec-error spikes, epsilon
    overspend and straggler-rate runaway.  Every verdict is a typed
    :class:`~repro.obs.HealthAlert` recorded to ``alerts.jsonl`` and the
    metric registry; what a FATAL verdict additionally does is ``policy``:

      * ``record``   — log only; training continues on the poisoned state
                       (monitors-on stays bit-exact with monitors-off);
      * ``warn``     — log + a Python warning;
      * ``abort``    — raise :class:`~repro.obs.HealthAbort`;
      * ``rollback`` — restore the last healthy global params + optimizer
                       state (one poisoned round degrades gracefully
                       instead of killing the run).  Non-recoverable fatal
                       alerts (epsilon overspend: the noise was already
                       released) degrade to ``warn``.
    """
    enabled: bool = False
    policy: str = "record"             # record | warn | abort | rollback
    window: int = 4                    # trailing rounds for spike baselines
    min_history: int = 2               # rounds before heuristic monitors arm
    loss_ratio_max: float = 50.0       # max(d/g, g/d) above this -> warn
    update_norm_factor: float = 10.0   # spike vs trailing median -> warn
    codec_error_factor: float = 10.0   # spike vs trailing median -> warn
    epsilon_budget: float = 0.0        # 0 = off; spend above this -> fatal
    straggler_rate_max: float = 0.5    # windowed straggler rate -> warn

    def __post_init__(self) -> None:
        _check_name("obs.health", "policy", self.policy, HEALTH_POLICIES)


@dataclass
class ObsConfig:
    """Flight recorder (src/repro/obs/): tracing, metrics, and profiling.

    ``enabled=False`` (default) records nothing and leaves every training
    path untouched — obs-off runs stay bit-exact with the pre-obs build
    (pinned test).  ``enabled=True`` attaches a :class:`~repro.obs.
    FlightRecorder` to the trainer:

      * spans for round -> download -> client-execution -> split-segment ->
        boundary-crossing -> uplink -> aggregate on the engine's virtual
        clock (plus wall-clock host spans), exported as Chrome-trace JSON;
      * a typed metric registry fed from each round's ``RoundFeedback``,
        snapshotted to ``metrics.jsonl``;
      * the full ``RoundFeedback`` + knob-decision history as JSONL, enough
        to replay the run through the pure controllers offline
        (``repro.obs.replay``) and reproduce the knob sequence bit-exactly.

    ``profile_kernels`` additionally times jit compiles and the fedavg /
    dp_clip kernels (roofline terms); it is gated off by default because
    profiling runs extra compilations — measurement only, numerics are
    never touched either way.
    """
    enabled: bool = False
    out_dir: str = "obs_runs"          # per-run dir created under this root
    run_id: str = ""                   # "" => derived from config + counter
    # which sinks are live when enabled; subset of OBS_SINKS
    sinks: Tuple[str, ...] = ("trace", "metrics", "feedback", "alerts",
                              "digests")
    trace_clock: str = "virtual"       # virtual | wall | both (export clocks)
    # cap batches whose segment/boundary phases are traced per client per
    # round (0 = no cap); rounds beyond the cap still get client spans
    trace_batches: int = 0
    profile_kernels: bool = False      # jit + kernel timing -> profile.json
    # numeric-health monitors (obs/health.py).  Orthogonal to ``enabled``:
    # health checks run whenever health.enabled is set, recorder or not —
    # a run can watch its own numerics without persisting anything.
    health: HealthConfig = field(default_factory=HealthConfig)

    def __post_init__(self) -> None:
        _check_name("obs", "trace_clock", self.trace_clock, OBS_TRACE_CLOCKS)
        for s in self.sinks:
            _check_name("obs", "sinks", s, OBS_SINKS)


@dataclass
class ShapeConfig:
    name: str = "train_4k"
    seq_len: int = 4096
    global_batch: int = 256
    mode: str = "train"                   # "train" | "prefill" | "decode"


# The four assigned input shapes.
INPUT_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    fsl: FSLConfig = field(default_factory=FSLConfig)
    fed: FedConfig = field(default_factory=FedConfig)
    split: SplitConfig = field(default_factory=SplitConfig)
    privacy: PrivacyConfig = field(default_factory=PrivacyConfig)
    control: ControlConfig = field(default_factory=ControlConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    shape: ShapeConfig = field(default_factory=lambda: INPUT_SHAPES["train_4k"])
    seed: int = 0

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunConfig":
        return _from_dict(cls, d)

    def override(self, dotted: Dict[str, Any]) -> "RunConfig":
        """Apply {'model.d_model': 512, ...} style overrides, returning a copy."""
        d = self.to_dict()
        for path, val in dotted.items():
            cur = d
            parts = path.split(".")
            for p in parts[:-1]:
                cur = cur[p]
            if parts[-1] not in cur:
                raise KeyError(f"unknown config key {path!r}")
            cur[parts[-1]] = _coerce(cur[parts[-1]], val)
        return RunConfig.from_dict(d)

    def validate(self) -> "RunConfig":
        m = self.model
        if m.family != DCGAN:
            if m.family != SSM and m.num_heads % max(1, m.num_kv_heads) != 0:
                raise ValueError("num_heads must be divisible by num_kv_heads")
            if m.moe.enabled and m.moe.top_k > m.moe.num_experts:
                raise ValueError("top_k > num_experts")
        if self.shape.mode == "decode" and m.family in (DENSE, MOE, VLM) \
                and self.shape.seq_len > 65536 and m.attention != ATTN_SLIDING:
            raise ValueError(
                f"{m.name}: long-context decode requires sub-quadratic attention "
                "(set model.attention='sliding')")
        return self


def _coerce(old: Any, new: Any) -> Any:
    if isinstance(new, str) and old is not None and not isinstance(old, str):
        t = type(old)
        if t is bool:
            return new.lower() in ("1", "true", "yes")
        return t(new)
    return new


def _from_dict(cls: Any, d: Dict[str, Any]) -> Any:
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[f.name] = _from_dict(f.type, v)
        elif f.name in _NESTED.get(cls, {}):
            kwargs[f.name] = _from_dict(_NESTED[cls][f.name], v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_NESTED = {
    ModelConfig: {"moe": MoEConfig, "mla": MLAConfig, "rwkv": RWKVConfig,
                  "rglru": RGLRUConfig, "encdec": EncDecConfig, "dcgan": DCGANConfig},
    ObsConfig: {"health": HealthConfig},
    RunConfig: {"model": ModelConfig, "parallel": ParallelConfig,
                "optim": OptimConfig, "fsl": FSLConfig, "fed": FedConfig,
                "split": SplitConfig, "privacy": PrivacyConfig,
                "control": ControlConfig, "obs": ObsConfig,
                "shape": ShapeConfig},
}


# ---------------------------------------------------------------------------
# Smoke reduction
# ---------------------------------------------------------------------------

def reduce_for_smoke(cfg: RunConfig, *, seq_len: int = 64, batch: int = 2) -> RunConfig:
    """Reduced variant of the same family: 2 layers, d_model<=512, <=4 experts."""
    d = cfg.to_dict()
    m = d["model"]
    m["num_layers"] = 2
    scale = max(1, m["d_model"] // 256)
    m["d_model"] = min(m["d_model"], 256)
    m["num_heads"] = max(1, min(m["num_heads"], 4))
    m["num_kv_heads"] = max(1, min(m["num_kv_heads"], m["num_heads"],
                                   max(1, m["num_kv_heads"])))
    if m["num_heads"] % m["num_kv_heads"]:
        m["num_kv_heads"] = 1
    m["head_dim"] = m["d_model"] // m["num_heads"]
    m["d_ff"] = min(m["d_ff"], 512)
    m["vocab_size"] = min(m["vocab_size"], 512)
    m["max_seq_len"] = max(seq_len * 2, 128)
    if m["moe"]["num_experts"]:
        m["moe"]["num_experts"] = 4
        m["moe"]["num_shared_experts"] = min(1, m["moe"]["num_shared_experts"])
        m["moe"]["top_k"] = 2
        m["moe"]["d_ff_expert"] = min(m["moe"]["d_ff_expert"] or 128, 128)
    if m["mla"]["kv_lora_rank"]:
        m["mla"]["kv_lora_rank"] = 64
        m["mla"]["rope_head_dim"] = 16
        m["mla"]["v_head_dim"] = m["head_dim"]
    if m["rwkv"]["head_dim"] and d["model"]["family"] == SSM:
        m["rwkv"]["head_dim"] = 32
        m["rwkv"]["decay_lora"] = 16
        m["rwkv"]["token_shift_lora"] = 8
        m["rwkv"]["gate_lora"] = 16
    if m["rglru"]["pattern"]:
        m["rglru"]["lru_width"] = m["d_model"]
        m["rglru"]["window"] = min(m["rglru"]["window"], seq_len)
    if m["encdec"]["encoder_layers"]:
        m["encdec"]["encoder_layers"] = 2
        m["encdec"]["encoder_seq"] = 32
    d["shape"] = {"name": "smoke", "seq_len": seq_len, "global_batch": batch,
                  "mode": d["shape"]["mode"]}
    d["parallel"]["microbatches"] = 1
    d["parallel"]["param_dtype"] = "float32"
    d["parallel"]["compute_dtype"] = "float32"
    out = RunConfig.from_dict(d)
    return out
