"""Operations and bytes counted from shapes, and the H100's published
peaks: the yardstick of the benchmark's utilisation and roofline metrics.

The peaks and ``roofline_terms`` / ``dp_clip_terms`` are copies of
``repro_torch/roofline/hw.py`` and ``repro_torch/roofline/analysis.py``,
frozen here so that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

from typing import Any, Dict

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
PEAK_FLOPS_BF16 = 989e12       # tensor cores
PEAK_FLOPS_FP32 = 67e12        # CUDA cores (TF32 off)
HBM_BW = 3.35e12               # bytes/s


def roofline_terms(flop: float, bytes_accessed: float) -> Dict[str, float]:
    """The least time a call could take: the larger of its operations at
    the fp32 peak and its bytes at the HBM bandwidth."""
    t_c = flop / PEAK_FLOPS_FP32
    t_m = bytes_accessed / HBM_BW
    return {"flop": flop, "bytes_accessed": bytes_accessed,
            "t_compute_s": t_c, "t_memory_s": t_m,
            "t_bound_s": max(t_c, t_m),
            "bound": "memory" if t_m >= t_c else "compute"}


def dp_clip_terms(batch: int, n: int) -> Dict[str, float]:
    """The DP-SGD release over a (B, N) fp32 per-example stack: the stack
    and the (N,) noise read once, the (N,) privatized sum written once; a
    square-and-add and a scale-and-add an element, one noise fma a
    column."""
    b, nn = float(batch), float(n)
    return roofline_terms(4.0 * b * nn + 2.0 * nn, 4.0 * (b * nn + 2.0 * nn))


# ---------------------------------------------------------------------------
# DCGAN (28x28 at the paper's widths): multiply-adds of each layer, x 2
# ---------------------------------------------------------------------------

def dcgan_disc_forward(m: Dict[str, Any]) -> float:
    """FLOPs of one image through D: the strided 5x5 convolutions and the
    classifier."""
    size, cin, total = m["image_size"], m["channels"], 0.0
    for i in range(m["conv_blocks"]):
        cout = m["base_filters"] * 2 ** i
        size = -(-size // 2)
        total += 2.0 * size * size * cout * 25 * cin
        cin = cout
    return total + 2.0 * size * size * cin


def dcgan_gen_forward(m: Dict[str, Any]) -> float:
    """FLOPs of one latent through G: the projection, two 5x5 stride-2
    transposed convolutions counted over their real input pixels (the
    inserted zeros are not model work) and the 5x5 output convolution."""
    f, s0 = m["base_filters"], m["image_size"] // 4
    proj = 2.0 * m["latent_dim"] * s0 * s0 * f * 4
    de0 = 2.0 * s0 * s0 * (f * 4) * 25 * (f * 2)
    de1 = 2.0 * (2 * s0) ** 2 * (f * 2) * 25 * f
    out = 2.0 * m["image_size"] ** 2 * 25 * f * m["channels"]
    return proj + de0 + de1 + out


def fsl_gan_round(m: Dict[str, Any], *, batch: int, clients: int,
                  steps: int) -> float:
    """Model FLOPs of one FSL-GAN round: G's forward for every fake batch a
    client trains on; each client's D steps, forward and backward (3x the
    forward) over the real and the fake batch; the server's G steps,
    forward and backward through G and D.  Per-example and recomputed
    work is not counted."""
    d, g = dcgan_disc_forward(m), dcgan_gen_forward(m)
    fakes = clients * steps * batch * g
    d_steps = clients * steps * 2 * batch * 3.0 * d
    g_steps = steps * batch * 3.0 * (g + d)
    return fakes + d_steps + g_steps


# ---------------------------------------------------------------------------
# decoder-only MoE language model training
# ---------------------------------------------------------------------------

def moe_active_matmul_params(m: Dict[str, Any]) -> float:
    """Parameters of the matrix products one token goes through: each
    layer's q, k, v, o projections, its router and its top-k experts'
    SwiGLU (three matrices), and the output head.  The embedding is a
    lookup."""
    d = m["d_model"]
    attn = d * m["num_heads"] * m["head_dim"] * 2 \
        + d * m["num_kv_heads"] * m["head_dim"] * 2
    router = d * m["num_experts"]
    experts = m["top_k"] * 3 * d * m["d_ff_expert"]
    return m["num_layers"] * (attn + router + experts) \
        + d * m["vocab_size"]


def lm_train_step(m: Dict[str, Any], *, batch: int, seq_len: int) -> float:
    """Model FLOPs of one training step: 6 x active parameters x tokens,
    plus causal attention's score and value products (half of the full
    S x S, forward and backward: 3 x 2 x S^2 x H x hd a layer and a
    sequence).  Remat's recompute and the capacity padding of the expert
    products are not counted."""
    tokens = batch * seq_len
    dense = 6.0 * moe_active_matmul_params(m) * tokens
    attn = m["num_layers"] * batch * 3.0 * 2.0 * seq_len ** 2 \
        * m["num_heads"] * m["head_dim"]
    return dense + attn
