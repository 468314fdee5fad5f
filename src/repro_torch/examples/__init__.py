"""Example scripts of the port (twins of the JAX package's ``examples/``):
each runs as ``python -m repro_torch.examples.<name>`` from the repository
root, on the GPU unless given ``--device cpu``, and writes its artifacts
under ``experiments/gan_torch/`` (``--out``).

  fsl_gan_mnist         — the paper's experiment: FSL-GAN on synthetic MNIST
  fed_async_demo        — sync vs async scheduling, codecs, stragglers
  device_selection_demo — the four selection strategies' plans and prices
  serve_demo            — batched prefill + greedy decode on an LM config
  quickstart            — split planning, a two-client FSL-GAN round, then
                          two LM train steps on a reduced olmoe-1b-7b
  adaptive_control_demo — the four controllers, recorded and replayed
  trace_viewer_demo     — a traced split round, health alerts and digests
  privacy_frontier_demo — gradient / activation inversion and membership
                          inference, then the DP-SGD defense re-attacked
  split_training_demo   — a round trained through the split, its cost,
                          and the leakage of the tensors it shipped
  federated_lm          — per-client LM replicas under FedAvg cadences
                          k = 1 and 4: loss and parameter-sync traffic
"""
