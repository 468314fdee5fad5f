"""FSL-GAN core (port of ``repro/core``): split planning, device
selection, the time model, FedAvg and the GAN trainer."""
