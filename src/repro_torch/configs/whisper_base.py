"""whisper-base — audio enc-dec, 6L(dec) d_model=512 8H d_ff=2048 vocab=51865.
6 encoder layers over 1500 mel frames (30 s). [arXiv:2212.04356]

The mel-spectrogram + 2-conv frontend is a STUB (models/frontends.py):
the batch carries precomputed (batch, 1500, 512) frame embeddings
(`enc_embeds`).
Decoder max positions = 448, so `long_500k` is skipped;
`decode_32k`/`prefill_32k` exercise the decoder against the stubbed encoder
context at the shapes' batch sizes with target length capped at 448.

Same configuration as ``repro/configs/whisper_base.py``.
"""
from repro_torch.config import (EncDecConfig, ModelConfig, OptimConfig,
                                ParallelConfig, RunConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="whisper-base", family="audio",
            num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
            head_dim=64, d_ff=2048, vocab_size=51865, max_seq_len=448,
            act="gelu", rope_theta=0.0,   # whisper uses learned/sinusoidal pos, no rope
            encdec=EncDecConfig(encoder_layers=6, encoder_seq=1500,
                                max_target_positions=448),
            source="[arXiv:2212.04356]",
        ),
        parallel=ParallelConfig(microbatches=1),
        optim=OptimConfig(lr=1e-3, weight_decay=0.0, schedule="linear",
                          warmup_steps=100, total_steps=5_000),
    ).validate()
