"""Runtime step builders of the port (``repro/runtime``): the train steps
(``train.py``) and the serving steps (``serve.py``)."""
from repro_torch.runtime.serve import (  # noqa: F401
    cache_length, make_decode_step, make_prefill_step)
from repro_torch.runtime.train import (  # noqa: F401
    make_fsl_train_step, make_train_step)
