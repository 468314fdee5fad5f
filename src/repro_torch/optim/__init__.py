from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, clip_by_global_norm, global_norm, make_optimizer, sgd,
)
from repro_torch.optim.schedule import make_schedule  # noqa: F401
