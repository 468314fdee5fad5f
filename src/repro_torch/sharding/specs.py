"""Logical-axis sharding rules.  Port of ``repro/sharding/specs.py``.

Parameters and activations are annotated with *logical* axis names; a
single rules table maps them to mesh axes.  A dimension whose size the
mesh axes' extent does not divide (or whose axes an earlier dimension
took) is replicated instead.  A spec is a :class:`PartitionSpec`, a tuple
with one entry a dimension (a mesh axis, a tuple of axes, or None),
trailing Nones dropped as JAX drops them; a sharding is a
:class:`Sharding`, a (mesh, spec) pair.

Logical axes (:func:`default_rules`, the production layout)
-----------------------------------------------------------
  embed    d_model dim                -> FSDP over ("pod","data") when enabled
  mlp      ffn hidden / fused q_dim   -> tensor-parallel over "model"
  kv       fused kv_dim               -> "model" when divisible
  experts  MoE expert dim             -> expert-parallel over "model"
  vocab    vocabulary dim             -> "model"
  batch    global batch               -> ("pod","data")
  seq      sequence (activations)     -> "model" when sequence_parallel
  layers/stack/conv/...               -> replicated

Model code is mesh-agnostic: it marks activations with :func:`constrain`,
the identity unless a policy is installed (:func:`set_activation_policy`).
The reference's policy is ``with_sharding_constraint``; the port runs on
one device and has no partitioner to constrain, so its policy
(:func:`make_activation_policy`) records each call's logical axes, shape
and resulting spec and returns the tensor unchanged: the dry run's check
that every constrained activation has a spec on the mesh.

The vectorized client program stacks every per-client tree and batch
along a leading ``clients`` axis: dim 0 is the ``clients`` logical axis
and the rest replicate, so a group whose client count the mesh divides
runs in contiguous per-device chunks (:func:`client_chunks`), and any
other runs whole on one device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.tree import leaves, tree_map, unflatten_like

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dimension mesh axes (``jax.sharding.PartitionSpec``)."""
    def __new__(cls, *axes):
        return super().__new__(cls, axes)


class Sharding(NamedTuple):
    mesh: Mesh
    spec: PartitionSpec


@dataclass
class AxisRules:
    """Map from logical axis name -> mesh axis (or tuple of axes)."""
    rules: Dict[str, MeshAxes] = field(default_factory=dict)
    fsdp: bool = True
    tensor_parallel: bool = True
    sequence_parallel: bool = True

    def mesh_axes_for(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical)


def default_rules(mesh: Mesh, parallel=None) -> AxisRules:
    """Production layout: batch/FSDP over (pod,data), TP/EP over model.
    ``parallel`` (a ``ParallelConfig``) switches FSDP, tensor and sequence
    parallelism off; None keeps all three."""
    axes = list(mesh.axis_names)
    data_axes: Tuple[str, ...] = tuple(a for a in ("pod", "data")
                                       if a in axes)
    model = "model" if "model" in axes else None
    fsdp = parallel.fsdp if parallel is not None else True
    tp = parallel.tensor_parallel if parallel is not None else True
    sp = parallel.sequence_parallel if parallel is not None else True
    rules: Dict[str, MeshAxes] = {
        "batch": data_axes or None,
        "embed": data_axes if fsdp else None,
        "mlp": model if tp else None,
        "kv": model if tp else None,
        "heads": model if tp else None,
        "experts": model if tp else None,
        "vocab": model if tp else None,
        "seq": model if sp else None,
        "state": None,
        "layers": None,
        "window": None,
    }
    return AxisRules(rules=rules, fsdp=fsdp, tensor_parallel=tp,
                     sequence_parallel=sp)


def mesh_axis_size(mesh: Mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def logical_spec(mesh: Mesh, rules: AxisRules, shape: Sequence[int],
                 logical: Sequence[Optional[str]]) -> PartitionSpec:
    """The spec of ``shape`` under ``rules``; an axis that does not divide
    its dimension evenly (or is taken by an earlier one) replicates."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                         f"logical axes {tuple(logical)}")
    out: List[MeshAxes] = []
    used: set = set()
    for dim, name in zip(shape, logical):
        ax = rules.mesh_axes_for(name)
        if ax is None:
            out.append(None)
            continue
        ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
        ax_t = tuple(a for a in ax_t if a not in used)
        if not ax_t or dim % mesh_axis_size(mesh, ax_t) != 0:
            out.append(None)
            continue
        used.update(ax_t)
        out.append(ax_t[0] if len(ax_t) == 1 else ax_t)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def spec_for_param(mesh: Mesh, rules: AxisRules, arr_or_shape,
                   logical: Sequence[Optional[str]]) -> Sharding:
    """The sharding of a tensor (or anything with ``.shape``, or a shape)
    with ``logical`` axes."""
    shape = tuple(getattr(arr_or_shape, "shape", arr_or_shape))
    return Sharding(mesh, logical_spec(mesh, rules, shape, logical))


# ---------------------------------------------------------------------------
# Activation-sharding policy hook
# ---------------------------------------------------------------------------

_ACTIVATION_POLICY: Optional[Callable] = None


def set_activation_policy(fn: Optional[Callable]) -> None:
    """fn(x, logical_axes: tuple) -> x, or None to clear."""
    global _ACTIVATION_POLICY
    _ACTIVATION_POLICY = fn


def constrain(x, logical_axes):
    """``x`` under the installed activation policy; the identity without
    one."""
    if _ACTIVATION_POLICY is None:
        return x
    return _ACTIVATION_POLICY(x, logical_axes)


class ActivationRecord(NamedTuple):
    logical: Tuple[Optional[str], ...]
    shape: Tuple[int, ...]
    sharding: Sharding


def make_activation_policy(mesh: Mesh, rules: AxisRules,
                           records: Optional[List[ActivationRecord]] = None
                           ) -> Callable:
    """A policy that appends each constrained activation's logical axes,
    shape and sharding on ``mesh`` to ``records`` (when given) and returns
    the tensor unchanged.  A shape that the logical axes do not fit
    raises, as the reference's ``logical_spec`` does."""
    def policy(x, logical_axes):
        shape = tuple(x.shape)
        sharding = Sharding(mesh, logical_spec(mesh, rules, shape,
                                               logical_axes))
        if records is not None:
            records.append(ActivationRecord(tuple(logical_axes), shape,
                                            sharding))
        return x
    return policy


class Lg(tuple):
    """A tuple of logical axis names used as a *leaf* in spec trees."""
    def __new__(cls, *names):
        return super().__new__(cls, names)


def is_lg(x) -> bool:
    return isinstance(x, Lg)


def tree_shardings(mesh: Mesh, rules: AxisRules, params_tree, logical_tree):
    """Zip a tree of tensors with a tree of :class:`Lg` leaves of the same
    structure into a tree of :class:`Sharding`."""
    try:
        specs = leaves(tree_map(lambda p, l: (p, l), params_tree,
                                logical_tree))
    except (ValueError, TypeError) as e:
        raise ValueError(f"param/spec tree mismatch: {e}") from None
    if not all(is_lg(l) for _, l in specs):
        raise ValueError("param/spec tree mismatch: a spec leaf is not Lg")
    return unflatten_like(params_tree, [
        Sharding(mesh, logical_spec(mesh, rules, tuple(p.shape), l))
        for p, l in specs])


def client_axis_rules(mesh: Mesh, axis: str = "clients") -> AxisRules:
    """Rules mapping the ``clients`` logical axis onto ``axis`` of
    ``mesh`` (replicated when the mesh has no such axis)."""
    return AxisRules(rules={"clients": axis if axis in mesh.axis_names
                            else None})


def stacked_shardings(mesh: Mesh, tree, *, axis: str = "clients",
                      rules: Optional[AxisRules] = None):
    """Shardings for a stacked per-client tree: every leaf's leading dim
    is the ``clients`` logical axis, the rest replicate."""
    rules = client_axis_rules(mesh, axis) if rules is None else rules
    logical = tree_map(lambda l: Lg("clients", *(None,) * (l.dim() - 1)),
                       tree)
    return tree_shardings(mesh, rules, tree, logical)


def client_chunks(mesh: Mesh, num_clients: int, axis: str = "clients"
                  ) -> Optional[List[Tuple[torch.device, int, int]]]:
    """Where a stacked client axis of ``num_clients`` runs: ``[(device,
    lo, hi)]``, contiguous chunks over the mesh's devices, or None when
    the axis replicates (the mesh has no ``axis``, one device, or a count
    it does not divide)."""
    spec = logical_spec(mesh, client_axis_rules(mesh, axis),
                        (num_clients,), ("clients",))
    if not spec or len(mesh.devices) == 1:
        return None
    per = num_clients // len(mesh.devices)
    return [(dev, k * per, (k + 1) * per)
            for k, dev in enumerate(mesh.devices)]
