"""Client programs: the per-client local round as data.  Port of
``repro/fed/programs.py`` for the loop backend; the vectorized backend
waits for ROADMAP Queue A item 7.

  * :func:`make_local_step` builds ONE step definition — plain, or DP-SGD
    (per-example clip + Gaussian noise via ``kernels/dp_clip``, per-example
    gradients from ``torch.func.vmap`` over singleton batches) — and,
    orthogonally, computes the gradient either from the monolithic loss or
    through a ``core/split.SplitExecution`` (staged forward/backward, a
    boundary stage on every crossing tensor);
  * :class:`LocalProgram` runs it as a per-client loop of steps, one step
    per split signature;
  * :class:`RoundExecutor` binds a program to one engine round: data
    sampling, per-client hyperparameters (``lr_scale`` / ``local_steps``
    schedules), opt-state lookup and noise keys.  Execution is pure —
    optimizer states are returned in :class:`ClientResult`, never written
    back; the engine decides which clients participated and only those
    states commit.

Noise-key contract (:mod:`repro_torch.keys`): a step's noise depends only
on (round key, cohort, client roster index, execution index, batch index).

:func:`stack_trees` / :func:`fedavg_stacked` are the stacked-tree reduce
the edge hierarchy's decode pre-reduce uses.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import keys
from repro_torch.kernels.fedavg.ops import fedavg_flat
from repro_torch.tree import leaves, tree_map, value_and_grad

# loss_fn(params, real_batch, fake_batch) -> scalar loss
LossFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]

BACKENDS = ("loop",)


def stack_trees(trees: Sequence) -> Any:
    """[tree_0 .. tree_{C-1}] -> one tree with a leading client axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def fedavg_stacked(stacked_tree, weights: Sequence[float], *,
                   use_kernel: bool = False):
    """Weighted average over the leading client axis of a stacked tree.
    ``use_kernel`` sends each leaf through ``kernels/fedavg`` (the CUDA
    kernel for a CUDA tensor); otherwise a tensordot in fp32."""
    w = torch.tensor(list(weights), dtype=torch.float32,
                     device=leaves(stacked_tree)[0].device)
    w = w / torch.sum(w)
    if use_kernel:
        def avg(leaf):
            flat = leaf.reshape(leaf.shape[0], -1).to(torch.float32)
            return fedavg_flat(flat.contiguous(), w).reshape(
                leaf.shape[1:]).to(leaf.dtype)
    else:
        def avg(leaf):
            return torch.tensordot(w, leaf.to(torch.float32),
                                   dims=([0], [0])).to(leaf.dtype)
    return tree_map(avg, stacked_tree)


def _is_dp(privacy) -> bool:
    return (privacy is not None and getattr(privacy, "enabled", False)
            and privacy.mode == "dp_sgd")


def make_local_step(optimizer, loss_fn: LossFn, privacy=None, *,
                    split_exec=None):
    """``step(params, opt, real, fake, lr, key) -> (params, opt, loss)`` —
    the one client-side step.

    ``privacy`` is a ``config.PrivacyConfig`` (or None).  When it selects
    ``dp_sgd``, the step takes per-example gradients on singleton batches
    (``torch.func.vmap`` over examples, so batch-norm statistics are
    per-example), privatizes them through ``kernels/dp_clip`` with noise
    drawn from ``key`` and feeds the mean to the optimizer; otherwise it is
    the plain batch step and ``key`` feeds only a stochastic boundary
    stage.

    ``split_exec`` (``core/split.SplitExecution``, or None) selects HOW the
    gradient is computed: None differentiates the monolithic ``loss_fn``;
    a SplitExecution runs the staged split forward/backward, bit-exact with
    the monolithic gradient under the identity stage.
    """
    if not _is_dp(privacy):
        if split_exec is None:
            vg = value_and_grad(loss_fn)

            def step(params, opt, real, fake, lr, key=None):
                del key
                loss, grads = vg(params, real, fake)
                params, opt = optimizer.update(grads, opt, params, lr)
                return params, opt, loss
        else:
            def step(params, opt, real, fake, lr, key=None):
                loss, grads = split_exec.value_and_grad(params, real, fake,
                                                        key)
                params, opt = optimizer.update(grads, opt, params, lr)
                return params, opt, loss
        return step

    if split_exec is not None:
        raise NotImplementedError(
            "DP-SGD with the executed split is not ported to repro_torch "
            "yet (ROADMAP Queue A item 13)")
    from repro_torch.kernels.dp_clip.ops import dp_clip_noise_tree
    clip = float(privacy.clip_norm)
    noise_scale = float(privacy.noise_multiplier) * clip
    use_kernel = bool(privacy.use_kernel)

    def one_example(p, r, f):
        return loss_fn(p, r[None], f[None])

    per_example_vg = torch.func.vmap(torch.func.grad_and_value(one_example),
                                     in_dims=(None, 0, 0))

    def step(params, opt, real, fake, lr, key):
        with torch.enable_grad():
            per_ex, losses = per_example_vg(
                tree_map(torch.Tensor.detach, params), real, fake)
        summed = dp_clip_noise_tree(per_ex, clip, noise_scale, key,
                                    use_kernel=use_kernel)
        del per_ex
        b = real.shape[0]
        grads = tree_map(lambda g: g / b, summed)
        params, opt = optimizer.update(grads, opt, params, lr)
        return params, opt, torch.mean(losses)

    return step


class LocalProgram:
    """The per-client local round: one step definition, run as a loop of
    steps over a client's (T, B, ...) batches.

    ``split`` maps client ids to ``core/split.SplitExecution`` objects:
    those clients' steps execute THROUGH the split.  Steps are built per
    *split signature* (boundary depths + stage); unlisted clients run the
    monolithic step (signature ``None``), so split and unsplit clients
    coexist in one round.
    """

    def __init__(self, optimizer, loss_fn: LossFn, base_lr: float, *,
                 privacy=None, split=None):
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.base_lr = float(base_lr)
        self.privacy = privacy
        self.split = dict(split or {})
        self.is_dp = _is_dp(privacy)
        # does the step consume its noise key? (DP-SGD noise and/or a
        # stochastic boundary stage) — the trainer derives round keys iff so
        self.needs_key = self.is_dp or any(
            ex.stochastic for ex in self.split.values())
        self._exec_by_sig = {}
        for ex in self.split.values():
            self._exec_by_sig.setdefault(ex.signature, ex)
        self._step_cache: Dict[Any, Any] = {}
        self.step = self._step(None)

    def rebind_sigma(self, noise_multiplier: float) -> None:
        """The sigma controller's lever on the DP-SGD noise multiplier."""
        raise NotImplementedError(
            "LocalProgram.rebind_sigma is not ported to repro_torch yet "
            "(ROADMAP Queue A item 14: sigma control)")

    def signature_for(self, cid: str):
        """Step key for one client: its plan's boundary-depth/stage
        signature, or None for the monolithic step."""
        ex = self.split.get(cid)
        return ex.signature if ex is not None else None

    def _step(self, sig):
        if sig not in self._step_cache:
            self._step_cache[sig] = make_local_step(
                self.optimizer, self.loss_fn, self.privacy,
                split_exec=self._exec_by_sig.get(sig))
        return self._step_cache[sig]

    def run_looped(self, params, opt, reals, fakes, *,
                   lr: Optional[float] = None, key=None,
                   cid: Optional[str] = None
                   ) -> Tuple[Any, Any, List[float]]:
        """One client's round: T steps over (T, B, ...) batches, the noise
        key of step ``t`` being ``fold_in(key, t)``.  ``cid`` selects the
        client's split-signature step (monolithic when omitted or
        unlisted)."""
        lr = self.base_lr if lr is None else lr
        if key is None:
            key = keys.root(keys.DEFAULT, 0)
        step = self._step(self.signature_for(cid) if cid is not None
                          else None)
        losses: List[float] = []
        for t in range(reals.shape[0]):
            params, opt, l = step(params, opt, reals[t], fakes[t], lr,
                                  keys.fold_in(key, t))
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
    trainer's committed state.  ``round_key`` (a :mod:`repro_torch.keys`
    key, None when the program draws no noise) roots every execution's
    noise key.
    """

    def __init__(self, program: LocalProgram, *, backend: str,
                 sample: Callable[[str, int],
                                  Tuple[torch.Tensor, torch.Tensor]],
                 opt_lookup: Callable[[str], Any], default_steps: int,
                 hyper: Optional[Dict[str, ClientHyper]] = None,
                 round_key: Optional[keys.Key] = None,
                 cohort_of: Optional[Callable[[str], int]] = None):
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
        self.round_key = round_key
        # the edge hierarchy's cohort of a client, folded into the key
        # chain; None: cohort 0 for everyone
        self.cohort_of = cohort_of
        self._opt_overlay: Dict[str, Any] = {}
        self._exec_idx: Dict[str, int] = {}
        # stable roster index for noise keys: a hash of the id could hand
        # two clients the same noise.  Unlisted clients get indices past
        # the roster in first-execution order.
        self._cid_index: Dict[str, int] = {cid: i
                                           for i, cid in enumerate(self.hyper)}

    def steps_for(self, cid: str) -> int:
        h = self.hyper.get(cid)
        return (h.local_steps or self.default_steps) if h \
            else self.default_steps

    def lr_for(self, cid: str) -> float:
        h = self.hyper.get(cid)
        return self.program.base_lr * (h.lr_scale if h else 1.0)

    def _key_for(self, cid: str) -> Optional[keys.Key]:
        """Noise key of this execution: (round key, cohort, client roster
        index, execution index) — deterministic per schedule and distinct
        across clients (the roster index alone is unique)."""
        if self.round_key is None:
            return None
        if cid not in self._cid_index:
            self._cid_index[cid] = len(self._cid_index)
        i = self._exec_idx.get(cid, 0)
        self._exec_idx[cid] = i + 1
        cohort = int(self.cohort_of(cid)) if self.cohort_of else 0
        return keys.fold_in(self.round_key, cohort, self._cid_index[cid], i)

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
                lr=self.lr_for(cid), key=self._key_for(cid), cid=cid)
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
