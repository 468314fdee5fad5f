"""Runtime step builders of the port (``repro/runtime``).  The training
steps (``runtime/train.py``) wait for ROADMAP Queue A item 16."""
from repro_torch.runtime.serve import (  # noqa: F401
    cache_length, make_decode_step, make_prefill_step)
