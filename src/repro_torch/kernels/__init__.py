"""Hand-written Hopper kernels of the port, one package per TPU kernel of
``repro/kernels``, and one (adamw) that replaces no TPU kernel.

Each kernel package: ``kernel.py`` (the CUDA kernel's wrapper: checks,
launch, launch count), ``ops.py`` (the public op: layout glue, CUDA tensor
-> kernel, CPU tensor -> plain version) and ``ref.py`` (the plain PyTorch
version).  Sources live in ``repro_torch/csrc`` and build with
:mod:`repro_torch.kernels.build`.

  fedavg          weighted parameter average (the paper's server aggregation)
  dp_clip         DP-SGD per-example clip, sum and noise
  boundary_fuse   codec qdq + per-example clip + noise on a split crossing
  agg_fuse        the compressed-domain server reduce: dequantise-and-reduce
                  over wire stacks, a streamed dequantise-accumulate, and a
                  sparse top-k scatter-accumulate
  flash_attention blockwise online-softmax attention (GQA, causal and
                  sliding-window masks) for the LM substrate's forward
  wkv6            the RWKV-6 recurrence for the LM substrate's forward
  adamw           the optimizer's global-norm clip and AdamW update over a
                  whole parameter tree, or C clients' stacked trees at once
                  (the JAX optimizer is plain JAX)
"""
