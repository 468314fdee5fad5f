"""DCGAN (Radford et al. 2016) — the paper's model: 3-conv-block
discriminator + transposed-conv generator for 28x28x1 MNIST.
Port of ``repro/models/dcgan.py``.

Parameters keep the JAX package's keys and layouts: convolution kernels are
HWIO, images NHWC at every public function.  The NHWC->NCHW and HWIO->OIHW
permutes happen inside :func:`disc_apply_layer` and :func:`gen_apply`.

Three layout facts of the reference that a naive port gets wrong:

* JAX ``SAME`` padding with stride 2 and a 5x5 kernel is asymmetric —
  (1, 2) at sizes 28 and 14, (2, 2) at size 7 — so the strided convs pad
  explicitly (:func:`_same_pads`) instead of ``conv2d(padding=2)``;
* ``lax.conv_transpose(..., "SAME")`` does not flip its kernel: it is a
  plain convolution over the zero-inserted input padded (3, 2)
  (:func:`_deconv`);
* batch norm uses the per-batch biased variance, eps 1e-5, no running stats.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.config import DCGANConfig
from repro_torch.sharding.specs import Lg

Device = Union[str, torch.device]


def _normal(gen: torch.Generator, shape, scale: float, device: Device,
            dtype: torch.dtype) -> torch.Tensor:
    """Scaled standard normal drawn on the CPU from ``gen`` (so a seed gives
    the same parameters on every device), then moved to ``device``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return w.to(device=device, dtype=dtype)


def _conv_init(gen, kh, kw, cin, cout, device, dtype=torch.float32):
    fan = kh * kw * cin
    return {"w": _normal(gen, (kh, kw, cin, cout), (2.0 / fan) ** 0.5 * 0.7,
                         device, dtype),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def _bn_init(c, device, dtype=torch.float32):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def _bn_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Batch norm of an NCHW tensor over (N, H, W) with per-batch
    statistics (GAN training keeps no running stats)."""
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["scale"].view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` along one spatial dim: output
    ``ceil(size / stride)``, the odd pixel of the total goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW with the standard NCHW strides.  With one channel the
    permuted view's strides also read as channels-last, and the convolution
    backends then take another algorithm with other rounding: without this,
    a batch that went through ``torch.stack`` would not give the same bits
    as the same batch fresh from the generator."""
    y = x_nhwc.permute(0, 3, 1, 2)
    _, c, h, w = y.shape
    if y.stride()[1:] == (h * w, w, 1):
        return y
    return y.clone(memory_format=torch.contiguous_format)


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor, stride: int
               ) -> torch.Tensor:
    """``lax.conv_general_dilated(..., padding="SAME")`` on NCHW ``x``."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    hlo, hhi = _same_pads(x.shape[2], kh, stride)
    wlo, whi = _same_pads(x.shape[3], kw, stride)
    x = F.pad(x, (wlo, whi, hlo, hhi))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1).to(x.dtype), stride=stride)


# ---------------------------------------------------------------------------
# Discriminator — an ordered stack of named layers (splittable)
# ---------------------------------------------------------------------------

def disc_layer_names(c: DCGANConfig) -> List[str]:
    names = []
    for i in range(c.conv_blocks):
        names.append(f"conv{i}")
    names.append("classifier")
    return names


def disc_layer_costs(c: DCGANConfig, image_size: int = 0) -> Dict[str, float]:
    """Relative FLOP cost per layer (drives the split planner)."""
    s = image_size or c.image_size
    f = c.base_filters
    costs = {}
    cin, sz = c.channels, s
    for i in range(c.conv_blocks):
        cout = f * (2 ** i)
        costs[f"conv{i}"] = 25.0 * cin * cout * (sz / 2) ** 2
        cin, sz = cout, sz / 2
    costs["classifier"] = cin * sz * sz * 1.0
    return costs


def disc_init(gen: torch.Generator, c: DCGANConfig, device: Device,
              dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    cin = c.channels
    for i in range(c.conv_blocks):
        cout = c.base_filters * (2 ** i)
        p[f"conv{i}"] = _conv_init(gen, 5, 5, cin, cout, device, dtype)
        if i > 0:
            p[f"conv{i}"]["bn"] = _bn_init(cout, device, dtype)
        cin = cout
    # padded strided convs give ceil: 28 -> 14 -> 7 -> 4
    final_sz = -(-c.image_size // (2 ** c.conv_blocks))
    n_in = final_sz * final_sz * cin
    p["classifier"] = {
        "w": _normal(gen, (n_in, 1), n_in ** -0.5, device, dtype),
        "b": torch.zeros((1,), dtype=dtype, device=device)}
    return p


def disc_specs(c: DCGANConfig) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    for i in range(c.conv_blocks):
        p[f"conv{i}"] = {"w": Lg(None, None, None, "mlp"), "b": Lg("mlp")}
        if i > 0:
            p[f"conv{i}"]["bn"] = {"scale": Lg("mlp"), "bias": Lg("mlp")}
    p["classifier"] = {"w": Lg("mlp", None), "b": Lg(None)}
    return p


def disc_apply_layer(name: str, p, x: torch.Tensor, c: DCGANConfig
                     ) -> torch.Tensor:
    """Apply one named discriminator layer (the unit of an FSL portion).
    ``x`` is NHWC; a conv layer returns NHWC, the classifier (B, 1)."""
    if name.startswith("conv"):
        lp = p[name]
        y = _conv_same(_nchw(x), lp["w"], 2)
        y = y + lp["b"].to(y.dtype).view(1, -1, 1, 1)
        if "bn" in lp:
            y = _bn_apply(lp["bn"], y)
        return F.leaky_relu(y, 0.2).permute(0, 2, 3, 1)
    if name == "classifier":
        lp = p["classifier"]
        flat = x.reshape(x.shape[0], -1)
        return flat @ lp["w"].to(flat.dtype) + lp["b"].to(flat.dtype)
    raise ValueError(name)


def disc_apply(p, images: torch.Tensor, c: DCGANConfig) -> torch.Tensor:
    """images: (B, H, W, C) in [-1, 1] -> logits (B, 1)."""
    x = images
    for name in disc_layer_names(c):
        x = disc_apply_layer(name, p, x, c)
    return x


# ---------------------------------------------------------------------------
# Generator — trained by the central server (never sees real data)
# ---------------------------------------------------------------------------

def gen_init(gen: torch.Generator, c: DCGANConfig, device: Device,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    f = c.base_filters
    s0 = c.image_size // 4            # 7 for 28x28
    return {
        "proj": {"w": _normal(gen, (c.latent_dim, s0 * s0 * f * 4),
                              c.latent_dim ** -0.5, device, dtype),
                 "b": torch.zeros((s0 * s0 * f * 4,), dtype=dtype,
                                  device=device),
                 "bn": _bn_init(f * 4, device, dtype)},
        # deconv kernels stored (H, W, Cin, Cout), as lax.conv_transpose
        # with transpose_kernel=False reads them
        "deconv0": {**_conv_init(gen, 5, 5, f * 4, f * 2, device, dtype),
                    "bn": _bn_init(f * 2, device, dtype)},
        "deconv1": {**_conv_init(gen, 5, 5, f * 2, f, device, dtype),
                    "bn": _bn_init(f, device, dtype)},
        "out": _conv_init(gen, 5, 5, f, c.channels, device, dtype),
    }


def gen_specs(c: DCGANConfig) -> Dict[str, Any]:
    bn = {"scale": Lg(None), "bias": Lg(None)}
    return {
        "proj": {"w": Lg(None, "mlp"), "b": Lg("mlp"), "bn": bn},
        "deconv0": {"w": Lg(None, None, "mlp", None), "b": Lg(None),
                    "bn": bn},
        "deconv1": {"w": Lg(None, None, "mlp", None), "b": Lg(None),
                    "bn": bn},
        "out": {"w": Lg(None, None, None, None), "b": Lg(None)},
    }


def _transpose_same_pads(k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding ``lax.conv_transpose`` applies for ``SAME``
    around the zero-inserted input: (3, 2) for k=5, stride 2."""
    total = k + stride - 2
    lo = k - 1 if stride > k - 1 else -(-total // 2)
    return lo, total - lo


def _deconv(x: torch.Tensor, lp, stride: int = 2) -> torch.Tensor:
    """``lax.conv_transpose(x, w, (s, s), "SAME")`` on NCHW ``x``:
    zero-insert, pad, then an unflipped convolution."""
    b, ch, h, w = x.shape
    z = x.new_zeros((b, ch, (h - 1) * stride + 1, (w - 1) * stride + 1))
    z[:, :, ::stride, ::stride] = x
    hlo, hhi = _transpose_same_pads(lp["w"].shape[0], stride)
    wlo, whi = _transpose_same_pads(lp["w"].shape[1], stride)
    z = F.pad(z, (wlo, whi, hlo, hhi))
    y = F.conv2d(z, lp["w"].permute(3, 2, 0, 1).to(x.dtype))
    return y + lp["b"].to(y.dtype).view(1, -1, 1, 1)


def gen_apply(p, z: torch.Tensor, c: DCGANConfig) -> torch.Tensor:
    """z: (B, latent) -> images (B, H, W, C) in (-1, 1)."""
    f = c.base_filters
    s0 = c.image_size // 4
    b = z.shape[0]
    x = z @ p["proj"]["w"].to(z.dtype) + p["proj"]["b"].to(z.dtype)
    x = x.reshape(b, s0, s0, f * 4).permute(0, 3, 1, 2)
    x = torch.relu(_bn_apply(p["proj"]["bn"], x))
    x = torch.relu(_bn_apply(p["deconv0"]["bn"], _deconv(x, p["deconv0"])))
    x = torch.relu(_bn_apply(p["deconv1"]["bn"], _deconv(x, p["deconv1"])))
    x = _conv_same(x, p["out"]["w"], 1)
    x = x + p["out"]["b"].to(x.dtype).view(1, -1, 1, 1)
    return torch.tanh(x).permute(0, 2, 3, 1)
