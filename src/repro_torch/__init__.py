"""PyTorch/CUDA port of the FSL-GAN system (``src/repro``, JAX) for NVIDIA
Hopper GPUs.

The layout mirrors the JAX package module for module
(``repro/core/gan.py`` -> ``repro_torch/core/gan.py``), so every module here
names its reference.  Parameters are nested dicts of tensors with the same
keys and leaf shapes as the JAX trees (convolution kernels HWIO, images
NHWC at the public functions), which makes the parameter bridge
(:mod:`repro_torch.bridge`) a plain copy.

Every kernel the JAX package wrote in Pallas for the TPU is written by hand
for Hopper under ``repro_torch/csrc`` and built at first use
(:mod:`repro_torch.kernels.build`).  Entry points run on the GPU unless the
caller passes ``device="cpu"``; on the CPU each kernel wrapper takes its
plain PyTorch version.

This package imports neither ``jax`` nor ``repro``.
"""
