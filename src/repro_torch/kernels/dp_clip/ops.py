"""Public dp_clip op: tree <-> flat glue around the dp_clip kernel (port of
``repro/kernels/dp_clip/ops.py``).

``dp_clip_noise_tree`` is what the DP-SGD step calls: per-example gradient
tree in, privatized *summed* gradient tree out (the caller divides by the
batch size).  The whole tree is flattened into ONE (B, N) stack in
:func:`repro_torch.tree.leaves` order, so the clip norm is the global L2
over all parameters and noise element ``n`` lands on the same parameter as
in the JAX package.

With ``use_kernel`` a CUDA tensor goes through the hand-written kernel,
which launches or raises; a CPU tensor takes the plain version
(``ref.py``), as does a CUDA tensor when the caller did not ask for the
kernel.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import keys
from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
from repro_torch.kernels.dp_clip.ref import dp_clip_noise_ref
from repro_torch.tree import leaves, unflatten_like


def dp_clip_noise_flat(stacked: torch.Tensor, clip, noise_scale,
                       noise: torch.Tensor, *, use_kernel: bool = True
                       ) -> torch.Tensor:
    """stacked: (B, N) -> (N,) f32 privatized gradient sum."""
    if stacked.device.type == "cuda" and use_kernel:
        return dp_clip_noise_kernel(stacked, float(clip), float(noise_scale),
                                    noise)
    if stacked.device.type in ("cpu", "cuda"):
        return dp_clip_noise_ref(stacked, clip, noise_scale, noise)
    raise ValueError(f"dp_clip_noise_flat: no path for device "
                     f"{stacked.device}")


def flatten_per_example(tree) -> Tuple[torch.Tensor, Any]:
    """Per-example grad tree (every leaf (B, ...)) -> ((B, N) stack, spec),
    built with one ``torch.cat`` in ``leaves`` order."""
    ls = leaves(tree)
    b = ls[0].shape[0]
    flat = torch.cat([l.reshape(b, -1).to(torch.float32) for l in ls], dim=1)
    spec = (tree, [tuple(l.shape[1:]) for l in ls], [l.dtype for l in ls])
    return flat, spec


def unflatten_summed(vec: torch.Tensor, spec) -> Any:
    """(N,) privatized sum -> gradient tree with the original leaf shapes."""
    tree, shapes, dtypes = spec
    out, off = [], 0
    for shape, dtype in zip(shapes, dtypes):
        size = 1
        for s in shape:
            size *= s
        out.append(vec[off:off + size].reshape(shape).to(dtype))
        off += size
    return unflatten_like(tree, out)


def dp_clip_noise_tree(per_example_grads, clip, noise_scale, key, *,
                       use_kernel: bool = True):
    """Privatize a per-example gradient tree.

    per_example_grads: tree of (B, ...) leaves.  Returns the tree of
    ``sum_b clip_b(g_b) + noise_scale * N(0, I)`` — divide by B for the
    DP-SGD mean gradient.  ``noise_scale`` is sigma * clip for the Gaussian
    mechanism.  One normal draw per parameter, on the gradients' device,
    from the noise key ``key`` (:mod:`repro_torch.keys`).
    """
    flat, spec = flatten_per_example(per_example_grads)
    noise = keys.normal(key, (flat.shape[1],), flat.device)
    vec = dp_clip_noise_flat(flat, clip, noise_scale, noise,
                             use_kernel=use_kernel)
    return unflatten_summed(vec, spec)
