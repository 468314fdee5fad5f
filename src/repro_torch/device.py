"""Where the port's entry points run."""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fp32_convolutions():
    """Run the block with cuDNN's TF32 off, then restore the flag.

    PyTorch lets cuDNN compute float32 convolutions in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is off, and the port's parity
    contract is float32.  Only that flag changes: cuDNN stays enabled and
    its algorithm choice (``benchmark``, ``deterministic``) is the
    caller's.  (``torch.backends.cudnn.flags(allow_tf32=False)`` would
    also set ``enabled=False`` for the block.)  Usable as a decorator."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
