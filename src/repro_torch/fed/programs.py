"""Client programs: the per-client local round as data.  Port of
``repro/fed/programs.py`` for the plain step and the loop backend; DP-SGD
(ROADMAP Queue A item 4), the split step (item 5) and the vectorized
backend (item 7) wait.

  * :func:`make_local_step` builds the client-side step;
  * :class:`LocalProgram` runs it as a per-client loop of steps;
  * :class:`RoundExecutor` binds a program to one engine round: data
    sampling, per-client hyperparameters (``lr_scale`` / ``local_steps``
    schedules) and opt-state lookup.  Execution is pure — optimizer states
    are returned in :class:`ClientResult`, never written back; the engine
    decides which clients participated and only those states commit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.tree import value_and_grad

# loss_fn(params, real_batch, fake_batch) -> scalar loss
LossFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]

BACKENDS = ("loop",)


def make_local_step(optimizer, loss_fn: LossFn):
    """``step(params, opt, real, fake, lr) -> (params, opt, loss)`` — the
    plain batch step: value and gradient of ``loss_fn``, then one optimizer
    update."""
    vg = value_and_grad(loss_fn)

    def step(params, opt, real, fake, lr):
        loss, grads = vg(params, real, fake)
        params, opt = optimizer.update(grads, opt, params, lr)
        return params, opt, loss

    return step


class LocalProgram:
    """The per-client local round: one step definition, run as a loop of
    steps over a client's (T, B, ...) batches."""

    def __init__(self, optimizer, loss_fn: LossFn, base_lr: float):
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.base_lr = float(base_lr)
        self.step = make_local_step(optimizer, loss_fn)

    def run_looped(self, params, opt, reals, fakes, *,
                   lr: Optional[float] = None
                   ) -> Tuple[Any, Any, List[float]]:
        """One client's round: T steps over (T, B, ...) batches."""
        lr = self.base_lr if lr is None else lr
        losses: List[float] = []
        for t in range(reals.shape[0]):
            params, opt, l = self.step(params, opt, reals[t], fakes[t], lr)
            losses.append(float(l))
        return params, opt, losses


@dataclass(frozen=True)
class ClientHyper:
    """Per-client local-round hyperparameters (cfg.fed schedules)."""
    lr_scale: float = 1.0
    local_steps: int = 0          # 0 => the round's default


@dataclass
class ClientResult:
    """Pure output of one client execution — nothing is written back."""
    client_id: str
    params: Any
    opt_state: Any                # None for bare-callable programs
    info: Dict[str, Any] = field(default_factory=dict)


class RoundExecutor:
    """What the engine schedules: ``run(cids, start_params)`` executes the
    listed clients' local rounds and returns pure :class:`ClientResult`
    objects.

    ``sample(cid, steps) -> (reals, fakes)`` is called once per execution
    in schedule order, so the host-RNG stream under sync scheduling is the
    sequential trainer's.  Optimizer state reads go through a per-round
    overlay so a re-run of the same client chains without mutating the
    trainer's committed state.
    """

    def __init__(self, program: LocalProgram, *, backend: str,
                 sample: Callable[[str, int],
                                  Tuple[torch.Tensor, torch.Tensor]],
                 opt_lookup: Callable[[str], Any], default_steps: int,
                 hyper: Optional[Dict[str, ClientHyper]] = None):
        if backend not in BACKENDS:
            raise NotImplementedError(
                f"backend {backend!r} is not ported to repro_torch yet "
                f"(ROADMAP Queue A item 7: vectorized backend); ported: "
                f"{BACKENDS}")
        self.program = program
        self.backend = backend
        self.sample = sample
        self.opt_lookup = opt_lookup
        self.default_steps = int(default_steps)
        self.hyper = hyper or {}
        self._opt_overlay: Dict[str, Any] = {}

    def steps_for(self, cid: str) -> int:
        h = self.hyper.get(cid)
        return (h.local_steps or self.default_steps) if h \
            else self.default_steps

    def lr_for(self, cid: str) -> float:
        h = self.hyper.get(cid)
        return self.program.base_lr * (h.lr_scale if h else 1.0)

    def _opt_for(self, cid: str):
        if cid in self._opt_overlay:
            return self._opt_overlay[cid]
        return self.opt_lookup(cid)

    def run(self, cids: List[str], start_params) -> List[ClientResult]:
        out = []
        for cid in cids:
            steps = self.steps_for(cid)
            reals, fakes = self.sample(cid, steps)
            params, opt, losses = self.program.run_looped(
                start_params, self._opt_for(cid), reals, fakes,
                lr=self.lr_for(cid))
            self._opt_overlay[cid] = opt
            out.append(ClientResult(cid, params, opt,
                                    {"losses": losses, "steps": steps}))
        return out


class CallableProgram:
    """Adapter: a bare ``local_update(cid, params) -> (params, info)``
    callable as a program.  Opt state is opaque to the engine (None), so
    no ``RoundReport.opt_states`` entries are produced."""

    def __init__(self, fn):
        self.fn = fn

    def run(self, cids: List[str], start_params) -> List[ClientResult]:
        out = []
        for cid in cids:
            params, info = self.fn(cid, start_params)
            out.append(ClientResult(cid, params, None, info))
        return out


def as_program(obj):
    """Engine glue: accept a RoundExecutor-like program or a bare callable."""
    if hasattr(obj, "run"):
        return obj
    if callable(obj):
        return CallableProgram(obj)
    raise TypeError(f"not a client program: {obj!r}")
