"""Client-axis sharding rules (port of ``repro/sharding``)."""
from repro_torch.sharding.specs import (  # noqa: F401
    AxisRules, Lg, client_axis_rules, client_chunks, is_lg, logical_spec,
    mesh_axis_size, stacked_shardings, tree_shardings,
)
