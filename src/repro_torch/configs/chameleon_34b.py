"""chameleon-34b — VLM (early fusion), 48L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=65536. Images enter as VQ-VAE token ids interleaved with
text in one sequence; the transformer is a plain decoder over the mixed
vocabulary. [arXiv:2405.09818]

The VQ image tokenizer is a STUB frontend (models/frontends.py):
the batch carries already-tokenized mixed sequences; a modality mask
marks image spans for the example pipeline.

Same configuration as ``repro/configs/chameleon_34b.py``.
"""
from repro_torch.config import (ModelConfig, OptimConfig, ParallelConfig,
                                RunConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="chameleon-34b", family="vlm",
            num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
            head_dim=128, d_ff=22016, vocab_size=65536, max_seq_len=8192,
            qk_norm=True,   # chameleon uses qk-norm for training stability
            source="[arXiv:2405.09818]",
        ),
        parallel=ParallelConfig(param_dtype="bfloat16", microbatches=8),
        optim=OptimConfig(lr=1e-4, weight_decay=0.1, schedule="cosine",
                          warmup_steps=500, total_steps=20_000),
    ).validate()
