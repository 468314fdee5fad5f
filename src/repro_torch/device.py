"""Where the port's entry points run."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another.  Asking for CUDA where there is none raises; nothing carries
    on on the CPU unless the caller said so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the GPU; "
            "pass device='cpu' to run it on the CPU")
    return dev
