from repro_torch.config.base import (  # noqa: F401
    ATTN_FULL, ATTN_NONE, ATTN_SLIDING, AUDIO, BOUNDARY_STAGES, CODECS,
    CONTROL_MODES, CONTROLLERS, DCGAN, DENSE, FAMILIES, FED_BACKENDS,
    FED_MODES, HEALTH_POLICIES, HYBRID, INPUT_SHAPES, MOE, OBS_SINKS,
    OBS_TRACE_CLOCKS, PRIVACY_MODES, SELECTION_STRATEGIES, SERVER_REDUCES,
    SSM, VLM, ControlConfig, DCGANConfig, EncDecConfig, FedConfig,
    FSLConfig, HealthConfig, MLAConfig, ModelConfig, MoEConfig, ObsConfig,
    OptimConfig, ParallelConfig, PrivacyConfig, RGLRUConfig, RWKVConfig,
    RunConfig, ShapeConfig, SplitConfig, reduce_for_smoke,
)
