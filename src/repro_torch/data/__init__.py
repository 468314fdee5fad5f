from repro_torch.data.federated import partition_dirichlet  # noqa: F401
from repro_torch.data.synthetic import synthetic_mnist  # noqa: F401
