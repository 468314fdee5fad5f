"""qwen2-72b — dense, 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064. QKV bias (the Qwen signature), SwiGLU, RoPE. [arXiv:2407.10671]

Same configuration as ``repro/configs/qwen2_72b.py``.
"""
from repro_torch.config import (ModelConfig, OptimConfig, ParallelConfig,
                                RunConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="qwen2-72b", family="dense",
            num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
            head_dim=128, d_ff=29568, vocab_size=152064, max_seq_len=32768,
            qkv_bias=True, rope_theta=1_000_000.0,
            source="[arXiv:2407.10671]",
        ),
        parallel=ParallelConfig(param_dtype="bfloat16", microbatches=16),
        optim=OptimConfig(lr=1.5e-4, weight_decay=0.1, schedule="cosine",
                          warmup_steps=500, total_steps=20_000),
    ).validate()
