"""rwkv6-1.6b — SSM ("Finch"), 24L d_model=2048 attention-free d_ff=7168
vocab=65536. Data-dependent decay WKV recurrence, token-shift ddlerp,
channel-mix MLP. [arXiv:2404.05892]

Attention-free: decode state is O(heads * head_dim^2) per layer, so
`long_500k` runs natively.  Same configuration as
``repro/configs/rwkv6_1b6.py``.
"""
from repro_torch.config import (ModelConfig, OptimConfig, ParallelConfig,
                                RunConfig, RWKVConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="rwkv6-1.6b", family="ssm",
            num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
            head_dim=64, d_ff=7168, vocab_size=65536, max_seq_len=4096,
            attention="none",
            rwkv=RWKVConfig(head_dim=64, decay_lora=64, token_shift_lora=32,
                            gate_lora=64),
            source="[arXiv:2404.05892]",
        ),
        parallel=ParallelConfig(microbatches=1),
        optim=OptimConfig(lr=6e-4, weight_decay=0.0, schedule="cosine",
                          warmup_steps=100, total_steps=10_000),
    ).validate()
