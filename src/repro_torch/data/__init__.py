from repro_torch.data.federated import partition_dirichlet  # noqa: F401
from repro_torch.data.pipeline import BatchIterator  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    synthetic_lm_batch, synthetic_mnist, synthetic_tokens)
