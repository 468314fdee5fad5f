"""granite-20b — dense (code), 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152. Llama-style architecture with multi-query attention.
[arXiv:2405.04324]

Same configuration as ``repro/configs/granite_20b.py``.
"""
from repro_torch.config import (ModelConfig, OptimConfig, ParallelConfig,
                                RunConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="granite-20b", family="dense",
            num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
            head_dim=128, d_ff=24576, vocab_size=49152, max_seq_len=8192,
            source="[arXiv:2405.04324]",
        ),
        parallel=ParallelConfig(param_dtype="bfloat16", microbatches=8),
        optim=OptimConfig(lr=2e-4, weight_decay=0.1, schedule="cosine",
                          warmup_steps=200, total_steps=10_000),
    ).validate()
