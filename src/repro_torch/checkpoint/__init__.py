from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointManager, load_pytree, save_pytree,
)
