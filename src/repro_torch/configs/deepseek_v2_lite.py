"""deepseek-v2-lite-16b — MoE, 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400. MLA with kv_lora_rank=512 (decoupled rope dim 64),
2 shared + 64 routed experts, top-6. [arXiv:2405.04434]

The full V2 has 160 routed experts; V2-*Lite* has 64 (paper Table 1),
which is what this config uses.

Same configuration as ``repro/configs/deepseek_v2_lite.py``.
"""
from repro_torch.config import (MLAConfig, ModelConfig, MoEConfig, OptimConfig,
                                ParallelConfig, RunConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="deepseek-v2-lite-16b", family="moe",
            num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
            head_dim=128, d_ff=1408, vocab_size=102400, max_seq_len=32768,
            moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                          d_ff_expert=1408, router_aux_coef=0.003),
            mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                          v_head_dim=128),
            source="[arXiv:2405.04434]",
        ),
        parallel=ParallelConfig(param_dtype="bfloat16", microbatches=4),
        optim=OptimConfig(lr=4e-4, weight_decay=0.1, schedule="cosine",
                          warmup_steps=200, total_steps=10_000),
    ).validate()
