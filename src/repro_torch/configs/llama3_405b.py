"""llama3-405b — dense, 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. The scale stressor for the production mesh. [arXiv:2407.21783]

Training keeps bf16 params and bf16 Adam moments.

Same configuration as ``repro/configs/llama3_405b.py``.
"""
from repro_torch.config import (ModelConfig, OptimConfig, ParallelConfig,
                                RunConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="llama3-405b", family="dense",
            num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
            head_dim=128, d_ff=53248, vocab_size=128256, max_seq_len=8192,
            rope_theta=500_000.0,
            source="[arXiv:2407.21783]",
        ),
        parallel=ParallelConfig(param_dtype="bfloat16", microbatches=16,
                                accum_dtype="bfloat16"),
        optim=OptimConfig(lr=8e-5, weight_decay=0.1, schedule="cosine",
                          warmup_steps=2000, total_steps=50_000,
                          state_dtype="bfloat16"),
    ).validate()
