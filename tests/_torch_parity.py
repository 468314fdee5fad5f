"""The parity rule that the port's trainer tests hold parameters to
against the JAX trainer (``tests/test_torch_trainer.py``,
``tests/test_torch_vectorized.py``).

A test module takes it by importing it by name, as it imports the
``_hyp`` shim.
"""
from __future__ import annotations

import numpy as np

from repro_torch.tree import leaves

# Biases that feed straight into a batch norm: their analytic gradient is
# zero, the float gradient is rounding noise of 1e-7 .. 7e-7 (10-70x
# Adam's eps), so each Adam step moves them by about +-lr with a sign the
# noise picks, and the noise differs between frameworks.  They change no
# output.  Instead of the 1e-4 of the other leaves, each side must stay
# within lr x Adam steps of the shared initial value; the two sides can
# then differ by up to twice that.
BN_FED_BIASES = {("conv1", "b"), ("conv2", "b"), ("deconv0", "b"),
                 ("deconv1", "b")}


def paths(tree, prefix=()):
    """Key paths of a nested dict's leaves, in sorted key order (the order
    of ``jax.tree.leaves`` and ``repro_torch.tree.leaves``)."""
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]


def close_to_reference(got, want, start, drift: float,
                       noise_steps: bool = False) -> None:
    """The parity rule of ``test_train_epoch_matches_jax``: every leaf of
    the port's tree ``got`` within 1e-4 absolute of the JAX tree ``want``,
    BN-fed biases each within ``drift`` (lr x Adam steps) of their shared
    ``start``.

    ``noise_steps`` (the generator): Adam's first step moves an element by
    lr * g / (|g| + eps), so an element whose gradient is at rounding level
    (|g| ~ eps = 1e-8) moves by a fraction of lr that the rounding picks,
    as the BN-fed biases do every step.  Measured in the async round:
    G proj.w[53, 569] had a first-step gradient of +4.2e-9 here and -6.7e-9
    in JAX, a step difference of 1.39e-4 (ROADMAP Queue C).  A rounding
    that decides a discrete event does the same at full gradient size: an
    int8 code one quantum apart where an input lies within an ulp of a
    rounding tie, or a ReLU / leaky ReLU input within an ulp of its kink,
    makes the gradient jump, and Adam's steps part.  Measured in the
    vectorized split int8+dp round: 336 of 266,240 crossing codes one
    quantum apart, the first where the inputs differ by at most 1.0e-7
    (amax 0.238), and G's proj.w gradient jumping by 5.2e-3 in JAX's own
    function between two parameter sets 2.3e-5 apart (ROADMAP Queue C).
    Such elements may exceed 1e-4, at most one in 10,000 of a leaf, each
    within 2 x ``drift`` (the most two Adam walks can part)."""
    import jax   # here, so that test_torch_lm_gpu.py imports no JAX
    for path, g, w, s in zip(paths(got), leaves(got), jax.tree.leaves(want),
                             jax.tree.leaves(start)):
        if path[-2:] in BN_FED_BIASES:
            for side in (g.numpy(), w):
                np.testing.assert_allclose(side, s, rtol=0, atol=drift,
                                           err_msg=str(path))
        elif noise_steps:
            diff = np.abs(g.numpy() - w)
            assert int((diff > 1e-4).sum()) <= g.numel() // 10_000, path
            assert float(diff.max()) <= 2 * drift, path
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4,
                                       err_msg=str(path))
