"""dcgan-mnist — the paper's own model: DCGAN (Radford et al. 2016) with
3 conv blocks on 28x28x1 MNIST, latent dim 100, BATCH_SIZE=256,
24 batches/client/epoch, 5 clients x 4 devices. [paper §5]

Same configuration as ``repro/configs/dcgan_mnist.py``.
"""
from repro_torch.config import (DCGANConfig, FSLConfig, ModelConfig,
                                OptimConfig, ParallelConfig, RunConfig,
                                ShapeConfig)


def config() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="dcgan-mnist", family="dcgan",
            num_layers=3, d_model=0, num_heads=0, num_kv_heads=0,
            d_ff=0, vocab_size=0,
            dcgan=DCGANConfig(image_size=28, channels=1, latent_dim=100,
                              base_filters=64, conv_blocks=3),
            source="[arXiv:1511.06434; paper §5]",
        ),
        parallel=ParallelConfig(fsdp=False, tensor_parallel=False,
                                sequence_parallel=False,
                                param_dtype="float32", compute_dtype="float32"),
        # DCGAN defaults per Radford et al.: Adam(2e-4, beta1=0.5)
        optim=OptimConfig(name="adam", lr=2e-4, beta1=0.5, beta2=0.999,
                          weight_decay=0.0, grad_clip=0.0),
        fsl=FSLConfig(num_clients=5, devices_per_client=4,
                      selection="sorted_multi", local_steps=1,
                      lan_latency_s=0.050, heterogeneity="paper"),
        shape=ShapeConfig(name="mnist", seq_len=0, global_batch=256, mode="train"),
    )
