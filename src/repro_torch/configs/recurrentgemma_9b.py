"""recurrentgemma-9b — hybrid, 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000. RG-LRU recurrent blocks + local attention in a 1:2 pattern
(two recurrent blocks per local-attention block), window 2048. [arXiv:2402.19427]

`long_500k` runs natively: the recurrent state is O(1) and the attention
cache is bounded by the 2048-token window.

Same configuration as ``repro/configs/recurrentgemma_9b.py``.
"""
from repro_torch.config import (ModelConfig, OptimConfig, ParallelConfig,
                                RGLRUConfig, RunConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="recurrentgemma-9b", family="hybrid",
            num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
            head_dim=256, d_ff=12288, vocab_size=256000, max_seq_len=8192,
            attention="sliding", sliding_window=2048,
            rglru=RGLRUConfig(lru_width=4096, conv_width=4, window=2048,
                              pattern=("rglru", "rglru", "attn")),
            source="[arXiv:2402.19427]",
        ),
        parallel=ParallelConfig(param_dtype="bfloat16", microbatches=8),
        optim=OptimConfig(lr=4e-4, weight_decay=0.1, schedule="cosine",
                          warmup_steps=200, total_steps=10_000),
    ).validate()
