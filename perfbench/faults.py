"""Faults planted underneath the timed path, to show that ``correct`` sees
them: a step that returns its state unchanged, and half of each batch left
out with the mean taken over the rest (the first half stands in for the
second, so batch norm and per-example clipping see the first half only).
One chip holds each cell, so there is no exchange between chips to leave
out.  ``install`` returns a function that takes the fault out again."""
from __future__ import annotations

from typing import Callable

import torch

FAULTS = ("state_unchanged", "half_batch")


def _halved(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    first = x.narrow(axis, 0, n // 2)
    return torch.cat([first, first], dim=axis)


def install(driver: str, fault: str) -> Callable[[], None]:
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    undo = []

    def patch(owner, attr, fn):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    if fault == "state_unchanged":
        import repro_torch.optim.optimizers as oo
        made = oo.make_optimizer

        def make(cfg):
            opt = made(cfg)
            return oo.Optimizer(init=opt.init,
                                update=lambda g, s, p, lr: (p, s))
        patch(oo, "make_optimizer", make)
        import repro_torch.core.gan as gan
        import repro_torch.runtime.train as rt
        patch(gan, "make_optimizer", make)
        patch(rt, "make_optimizer", make)
    elif driver == "fsl_gan":
        from repro_torch.core.gan import FSLGANTrainer
        sample = FSLGANTrainer._sample_round_batches

        def halved(self, cid, steps):
            reals, fakes = sample(self, cid, steps)
            return _halved(reals, 1), _halved(fakes, 1)
        patch(FSLGANTrainer, "_sample_round_batches", halved)
    else:
        import repro_torch.runtime.train as rt
        build = rt.make_train_step

        def make_step(cfg):
            step = build(cfg)

            def halved(params, opt, batch, idx):
                return step(params, opt, {k: _halved(v, 0)
                                          for k, v in batch.items()}, idx)
            return halved
        patch(rt, "make_train_step", make_step)

    def remove():
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)
    return remove
