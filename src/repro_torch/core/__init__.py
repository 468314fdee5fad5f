"""FSL-GAN core (port of ``repro/core``): split planning and the executed
split, device selection, the time model, FedAvg and the GAN trainer."""
