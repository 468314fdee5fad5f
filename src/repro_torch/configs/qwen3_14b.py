"""qwen3-14b — dense, 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

qk_norm on query/key heads, SwiGLU MLP, RoPE. [hf:Qwen/Qwen3-8B]

Same configuration as ``repro/configs/qwen3_14b.py``.
"""
from repro_torch.config import (ModelConfig, OptimConfig, ParallelConfig,
                                RunConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="qwen3-14b", family="dense",
            num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
            head_dim=128, d_ff=17408, vocab_size=151936, max_seq_len=32768,
            qk_norm=True, rope_theta=1_000_000.0,
            source="[hf:Qwen/Qwen3-8B]",
        ),
        parallel=ParallelConfig(param_dtype="bfloat16", microbatches=8),
        optim=OptimConfig(lr=3e-4, weight_decay=0.1, schedule="cosine",
                          warmup_steps=200, total_steps=10_000),
    ).validate()
