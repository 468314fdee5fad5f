"""Public AdamW ops: one step over a parameter tree, or over C clients'
stacked trees at once.

CUDA leaves go through the hand-written kernels, which launch or raise;
CPU leaves take the plain version (the optimizer's global-norm clip, then
``ref.py`` a leaf; for stacked trees that, ``torch.func.vmap``-ed over
the clients).  A leaf that is not contiguous (autograd gives a
convolution weight's gradient in the layout of the permuted view the
forward took) is copied into row-major order first, the order of the
parameter it updates.
"""
from __future__ import annotations

import functools
from typing import Union

import torch

from repro_torch.kernels.adamw.kernel import adamw_leaves_kernel
from repro_torch.kernels.adamw.ref import adamw_ref
from repro_torch.tree import leaves, tree_map, unflatten_like


def adamw_plain(grads, m, v, params, bc1, bc2, lr, *, beta1: float,
                beta2: float, eps: float, weight_decay: float,
                grad_clip: float):
    """The plain form of one AdamW step over trees -> ``(new_params,
    new_m, new_v)``: the global-norm clip, then :func:`ref.adamw_ref` on
    every leaf."""
    # optimizers.py imports this module: take its clip at call time
    from repro_torch.optim.optimizers import clip_by_global_norm
    if grad_clip:
        grads, _ = clip_by_global_norm(grads, grad_clip)
    upd = functools.partial(adamw_ref, bc1=bc1, bc2=bc2, lr=lr, beta1=beta1,
                            beta2=beta2, eps=eps, weight_decay=weight_decay)
    out = tree_map(upd, grads, m, v, params)
    return tuple(tree_map(lambda o, i=i: o[i], out) for i in range(3))


def _device(name: str, trees) -> str:
    devices = {t.device.type for tree in trees for t in leaves(tree)}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"{name}: no path for leaves on {sorted(devices)}")
    return devices.pop()


def _kernel(grads, m, v, params, bc1, bc2, lr, hp):
    gs, ms, vs, ps = ([t if t.is_contiguous() else t.contiguous()
                       for t in leaves(tree)]
                      for tree in (grads, m, v, params))
    new_p, new_m, new_v = adamw_leaves_kernel(gs, ms, vs, ps, bc1, bc2, lr,
                                              **hp)
    return (unflatten_like(params, new_p), unflatten_like(m, new_m),
            unflatten_like(v, new_v))


def adamw_update(grads, m, v, params, bc1: torch.Tensor, bc2: torch.Tensor,
                 lr: Union[float, torch.Tensor], *, beta1: float,
                 beta2: float, eps: float, weight_decay: float,
                 grad_clip: float):
    """One AdamW step: ``grads``, ``m``, ``v``, ``params`` trees of one
    structure; ``bc1``, ``bc2`` the bias corrections ``1 - beta^t``, one
    element each; ``lr`` a number or a one-element tensor -> ``(new_params,
    new_m, new_v)``, new trees, the inputs not written.  Counts the leaves
    each path updated on ``adamw_leaves_kernel``."""
    hp = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
              grad_clip=grad_clip)
    trees = (grads, m, v, params)
    if _device("adamw_update", trees) == "cpu":
        adamw_leaves_kernel.plain_leaves += len(leaves(params))
        return adamw_plain(*trees, bc1, bc2, lr, **hp)
    if bc1.numel() != 1:
        raise ValueError(f"adamw_update: bc1 of {bc1.numel()} elements; "
                         f"stacked trees take adamw_update_stacked")
    return _kernel(*trees, bc1, bc2, lr, hp)


def adamw_update_stacked(grads, m, v, params, bc1: torch.Tensor,
                         bc2: torch.Tensor, lrs: torch.Tensor, *,
                         beta1: float, beta2: float, eps: float,
                         weight_decay: float, grad_clip: float):
    """One AdamW step for C clients at once: every leaf ``(C, ...)``, a
    client a row; ``bc1``, ``bc2``, ``lrs`` ``(C,)``.  Client ``c``'s rows
    come out as :func:`adamw_update` of client ``c``'s own trees with
    ``bc1[c]``, ``bc2[c]``, ``lrs[c]`` would give them, its clip by its
    own global norm.  On the card one call of the kernels for every
    client; on the CPU the plain form vmapped over the clients."""
    hp = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
              grad_clip=grad_clip)
    trees = (grads, m, v, params)
    c = bc1.numel()
    if bc1.dim() != 1 or any(x.dim() == 0 or x.shape[0] != c
                             for tree in trees for x in leaves(tree)):
        raise ValueError(f"adamw_update_stacked: every leaf needs a leading "
                         f"client axis of bc1's {c}")
    if _device("adamw_update_stacked", trees) == "cpu":
        adamw_leaves_kernel.plain_leaves += c * len(leaves(params))
        return torch.func.vmap(functools.partial(adamw_plain, **hp))(
            *trees, bc1, bc2, lrs)
    return _kernel(*trees, bc1, bc2, lrs, hp)
