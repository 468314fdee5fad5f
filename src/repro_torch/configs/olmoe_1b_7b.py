"""olmoe-1b-7b — MoE, 16L d_model=2048 16H (kv=16) d_ff(expert)=1024
vocab=50304. 64 routed experts, top-8, no shared experts, standard attention
(no MLA), qk-norm per the OLMoE recipe. [arXiv:2409.02060]

Same configuration as ``repro/configs/olmoe_1b_7b.py``.
"""
from repro_torch.config import (ModelConfig, MoEConfig, OptimConfig,
                                ParallelConfig, RunConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="olmoe-1b-7b", family="moe",
            num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
            head_dim=128, d_ff=1024, vocab_size=50304, max_seq_len=4096,
            qk_norm=True,
            moe=MoEConfig(num_experts=64, num_shared_experts=0, top_k=8,
                          d_ff_expert=1024, router_aux_coef=0.01),
            source="[arXiv:2409.02060]",
        ),
        parallel=ParallelConfig(microbatches=4),
        optim=OptimConfig(lr=4e-4, weight_decay=0.1, schedule="cosine",
                          warmup_steps=200, total_steps=10_000),
    ).validate()
