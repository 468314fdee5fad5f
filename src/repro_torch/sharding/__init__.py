"""Logical-axis sharding rules (port of ``repro/sharding``)."""
from repro_torch.sharding.specs import (  # noqa: F401
    ActivationRecord, AxisRules, Lg, PartitionSpec, Sharding,
    client_axis_rules, client_chunks, constrain, default_rules, is_lg,
    logical_spec, make_activation_policy, mesh_axis_size,
    set_activation_policy, spec_for_param, stacked_shardings,
    tree_shardings,
)
