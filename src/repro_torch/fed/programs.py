"""Client programs: the per-client local round as data, run two ways.
Port of ``repro/fed/programs.py``.

  * :func:`make_local_step` builds ONE step definition — plain, or DP-SGD
    (per-example clip + Gaussian noise via ``kernels/dp_clip``, per-example
    gradients from ``torch.func.vmap`` over singleton batches) — and,
    orthogonally, computes the gradient either from the monolithic loss or
    through a ``core/split.SplitExecution`` (staged forward/backward, a
    boundary stage on every crossing tensor);
  * :func:`make_vectorized_step` is the same step over a stacked client
    axis: the gradients from ``torch.func.vmap`` over clients, the kernels
    (dp_clip, boundary_fuse) called outside the vmap on each client's rows
    (a ctypes call does not run inside ``vmap``), the optimizer's stacked
    update over every client at once;
  * :class:`LocalProgram` runs a step as a per-client loop of steps
    (``loop``) or as one stacked step a batch for C clients
    (``vectorized``), one step definition per split signature;
  * :class:`RoundExecutor` binds a program to one engine round: data
    sampling, per-client hyperparameters (``lr_scale`` / ``local_steps``
    schedules), opt-state lookup, noise keys and, under the vectorized
    backend, placement on a client mesh.  Execution is pure — optimizer
    states are returned in :class:`ClientResult`, never written back; the
    engine decides which clients participated and only those states
    commit.

Noise-key contract (:mod:`repro_torch.keys`): a step's noise depends only
on (round key, cohort, client roster index, execution index, batch index),
so both backends draw the same noise.

:func:`stack_trees` / :func:`unstack_tree` / :func:`fedavg_stacked` are the
stacked-tree utilities and :func:`sequential_d_rounds` the per-client loop
the vectorized round is held against.

Host spans (``repro_torch/obs/trace.py``, recorded under an active
tracer): ``client`` is one ``RoundExecutor.run``; inside it ``sample`` is
one client's batches and ``group`` one dispatch (a signature group's
stacked round under ``vectorized``, one client's round under ``loop``),
and ``batch`` one step of it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import keys
from repro_torch.kernels.fedavg.ops import fedavg_leaves, normalised_weights
from repro_torch.obs.trace import span
from repro_torch.tree import leaves, tree_map, unflatten_like, value_and_grad

# loss_fn(params, real_batch, fake_batch) -> scalar loss
LossFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]

# The executor's dispatch paths.  ``config.FED_BACKENDS`` also accepts
# "auto", which the trainer resolves by a timed probe
# (core/gan.FSLGANTrainer._resolve_auto_backend) before it builds an
# executor, so "auto" never reaches this module.
BACKENDS = ("loop", "vectorized")


def stack_trees(trees: Sequence) -> Any:
    """[tree_0 .. tree_{C-1}] -> one tree with a leading client axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_tree(stacked, num: int) -> List[Any]:
    """Inverse of :func:`stack_trees`: row views of the stacked leaves."""
    return [tree_map(lambda x, i=i: x[i], stacked) for i in range(num)]


def fedavg_stacked(stacked_tree, weights: Sequence[float], *,
                   use_kernel: bool = False):
    """Weighted average over the leading client axis of a stacked tree.
    ``use_kernel`` sends the whole tree through ``kernels/fedavg`` in one
    :func:`fedavg_leaves` call (one launch on the card), each client's row
    of a leaf read in place; it normalises the normalised weights again,
    as the reference's ``fedavg_flat`` does.  Otherwise a tensordot in
    fp32."""
    flat = leaves(stacked_tree)
    w = normalised_weights(weights, flat[0].device)
    if use_kernel:
        rows = [l.to(torch.float32).contiguous().unbind(0) for l in flat]
        avgs = fedavg_leaves(list(zip(*rows)), w)
        return unflatten_like(stacked_tree, [
            a.to(l.dtype) for a, l in zip(avgs, flat)])
    return tree_map(lambda leaf: torch.tensordot(
        w, leaf.to(torch.float32), dims=([0], [0])).to(leaf.dtype),
        stacked_tree)


def sequential_d_rounds(d_step, params_list: Sequence, opt_list: Sequence,
                        reals: torch.Tensor, fakes: torch.Tensor):
    """What the vectorized round computes, as the per-client loop over the
    same (C, T, B, ...) batches: ``d_step(params, opt, real, fake) ->
    (params, opt, loss)``.  Returns the per-client params and opt states
    and the (C, T) losses."""
    out_p, out_o, out_l = [], [], []
    for i, (p, o) in enumerate(zip(params_list, opt_list)):
        losses = []
        for t in range(reals.shape[1]):
            p, o, l = d_step(p, o, reals[i, t], fakes[i, t])
            losses.append(l)
        out_p.append(p)
        out_o.append(o)
        out_l.append(torch.stack(losses))
    return out_p, out_o, torch.stack(out_l)


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
    the monolithic gradient under the identity stage.  Under DP-SGD it
    runs the split's per-example staged step
    (``SplitExecution.per_example_value_and_grad``), whose boundary-stage
    noise keys extend ``key``: dp_clip's noise (``key`` itself) stays
    independent of it.
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

    from repro_torch.kernels.dp_clip.ops import dp_clip_noise_tree
    clip = float(privacy.clip_norm)
    noise_scale = float(privacy.noise_multiplier) * clip
    use_kernel = bool(privacy.use_kernel)

    if split_exec is None:
        def one_example(p, r, f):
            return loss_fn(p, r[None], f[None])

        grad_one = torch.func.vmap(torch.func.grad_and_value(one_example),
                                   in_dims=(None, 0, 0))

        def per_example_vg(params, real, fake, key):
            del key
            with torch.enable_grad():
                per_ex, losses = grad_one(
                    tree_map(torch.Tensor.detach, params), real, fake)
            return losses, per_ex
    else:
        per_example_vg = split_exec.per_example_value_and_grad

    def step(params, opt, real, fake, lr, key):
        losses, per_ex = per_example_vg(params, real, fake, key)
        summed = dp_clip_noise_tree(per_ex, clip, noise_scale, key,
                                    use_kernel=use_kernel)
        del per_ex
        b = real.shape[0]
        grads = tree_map(lambda g: g / b, summed)
        params, opt = optimizer.update(grads, opt, params, lr)
        return params, opt, torch.mean(losses)

    return step


def make_vectorized_step(optimizer, loss_fn: LossFn, privacy=None, *,
                         split_exec=None):
    """``step(params, opt, real, fake, lrs, step_keys) -> (params, opt,
    losses)`` — :func:`make_local_step` over a leading client axis: every
    tree leaf and batch is ``(C, ...)``, ``lrs`` a (C,) fp32 tensor,
    ``step_keys`` one noise key a client, ``losses`` (C,).

    The step is three phases, because the port's kernels are ctypes calls
    that do not run inside ``torch.func.vmap``:

    (a) the gradients: the loss ``torch.func.vmap``-ed over clients under
        autograd, the summed client losses differentiated once (clients
        share nothing, so each client's rows of the gradient are its own);
        through a split, ``SplitExecution.clients_value_and_grad`` (each
        crossing's stage applied per client, on its row, with its key);
    (b) DP-SGD: per-example gradients as nested vmaps (clients outside,
        examples inside; through a split the per-example staged step over
        the client axis), then ``dp_clip_noise_tree`` once per client
        outside the vmap with that client's key: the loop's launches and
        inputs, and ``privacy.use_kernel`` honoured;
    (c) ``optimizer.update_stacked`` over the stacked trees, each client
        with its own learning rate (Adam's step counter becomes (C,)): for
        AdamW one call of its kernels for every client, outside any vmap;
        an optimizer without one (SGD) takes ``update`` vmapped over
        clients.
    """
    vmap = torch.func.vmap
    update = optimizer.update_stacked or vmap(optimizer.update)

    if not _is_dp(privacy):
        if split_exec is None:
            mapped = vmap(loss_fn)

            def value_and_grad_c(params, real, fake, step_keys):
                del step_keys
                with torch.enable_grad():
                    live = tree_map(
                        lambda p: p.detach().requires_grad_(True), params)
                    losses = mapped(live, real, fake)
                    grads = torch.autograd.grad(losses.sum(), leaves(live))
                return losses.detach(), unflatten_like(params, grads)
        else:
            value_and_grad_c = split_exec.clients_value_and_grad

        def step(params, opt, real, fake, lrs, step_keys):
            losses, grads = value_and_grad_c(params, real, fake, step_keys)
            params, opt = update(grads, opt, params, lrs)
            return params, opt, losses
        return step

    from repro_torch.kernels.dp_clip.ops import dp_clip_noise_tree
    clip = float(privacy.clip_norm)
    noise_scale = float(privacy.noise_multiplier) * clip
    use_kernel = bool(privacy.use_kernel)

    if split_exec is None:
        def one_example(p, r, f):
            return loss_fn(p, r[None], f[None])

        grad_all = vmap(vmap(torch.func.grad_and_value(one_example),
                             in_dims=(None, 0, 0)))

        def per_example_vg(params, real, fake, step_keys):
            del step_keys
            with torch.enable_grad():
                per_ex, losses = grad_all(
                    tree_map(torch.Tensor.detach, params), real, fake)
            return losses, per_ex
    else:
        per_example_vg = split_exec.clients_per_example_value_and_grad

    def step(params, opt, real, fake, lrs, step_keys):
        losses, per_ex = per_example_vg(params, real, fake, step_keys)
        summed = [dp_clip_noise_tree(tree_map(lambda g, c=c: g[c], per_ex),
                                     clip, noise_scale, k,
                                     use_kernel=use_kernel)
                  for c, k in enumerate(step_keys)]
        del per_ex
        b = real.shape[1]
        grads = tree_map(lambda *gs: torch.stack(gs) / b, *summed)
        params, opt = update(grads, opt, params, lrs)
        return params, opt, torch.mean(losses, dim=1)

    return step


class LocalProgram:
    """The per-client local round: one step definition, run two ways.

      * ``run_looped``     — T steps for one client over its (T, B, ...)
        batches;
      * ``run_vectorized`` — C clients stacked: T steps of the stacked
        step (:func:`make_vectorized_step`), per-client learning rates and
        noise keys, and a (C, T) step mask for ``local_steps`` schedules
        of different lengths.

    ``split`` maps client ids to ``core/split.SplitExecution`` objects:
    those clients' steps execute THROUGH the split.  Steps are built per
    *split signature* (boundary depths + stage); unlisted clients run the
    monolithic step (signature ``None``), so split and unsplit clients
    coexist in one round, and the vectorized backend stacks the clients of
    one signature (``RoundExecutor``).
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
        self._vstep_cache: Dict[Any, Any] = {}
        self.step = self._step(None)

    def rebind_sigma(self, noise_multiplier: float) -> None:
        """Rebind the DP-SGD noise multiplier between rounds (the sigma
        controller's lever).  The noise scale is a constant of each built
        step, so both step caches (loop and vectorized) are dropped and
        the next dispatch builds its steps at the new scale; the
        (round, cohort, client, exec, batch) noise keys are untouched, so
        a rebound run stays deterministic per schedule.  A no-op without
        DP-SGD or at the bound sigma."""
        if not self.is_dp or \
                float(noise_multiplier) == self.privacy.noise_multiplier:
            return
        self.privacy = dataclasses.replace(
            self.privacy, noise_multiplier=float(noise_multiplier))
        self._step_cache.clear()
        self._vstep_cache.clear()
        self.step = self._step(None)

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

    def _vstep(self, sig):
        if sig not in self._vstep_cache:
            self._vstep_cache[sig] = make_vectorized_step(
                self.optimizer, self.loss_fn, self.privacy,
                split_exec=self._exec_by_sig.get(sig))
        return self._vstep_cache[sig]

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
            with span("batch"):
                params, opt, l = step(params, opt, reals[t], fakes[t], lr,
                                      keys.fold_in(key, t))
                losses.append(float(l))
        return params, opt, losses

    def run_vectorized(self, stacked_params, stacked_opt, reals, fakes, *,
                       lrs=None, keys=None, mask=None, signature=None):
        """C clients' rounds as one stacked step a batch.

        ``reals``/``fakes``: (C, T, B, ...).  ``lrs``: C learning rates;
        ``keys``: C noise keys (client ``c``'s step ``t`` draws from
        ``fold_in(keys[c], t)``, as ``run_looped`` does); ``mask``: (C, T)
        bool on the host — a False slot is a padding step that leaves the
        client's state as it was; step ``t`` runs on the set clients' rows
        only, so a round makes the loop's kernel launches (dp_clip once a
        client a step taken).  ``signature`` selects the split step;
        every stacked client must share it (``RoundExecutor`` groups by
        signature).  Returns stacked (params, opt) and (C, T) losses, 0 at
        masked slots."""
        c, t_len = int(reals.shape[0]), int(reals.shape[1])
        dev = reals.device
        lrs = torch.tensor([self.base_lr] * c if lrs is None
                           else [float(l) for l in lrs],
                           dtype=torch.float32, device=dev)
        client_keys = [_DEFAULT_KEY] * c if keys is None else list(keys)
        mask = (torch.ones((c, t_len), dtype=torch.bool) if mask is None
                else torch.as_tensor(mask, dtype=torch.bool).cpu())
        step = self._vstep(signature)
        params, opt, losses = stacked_params, stacked_opt, []
        for t in range(t_len):
            with span("batch"):
                step_keys = [_fold_in(k, t) for k in client_keys]
                live = mask[:, t]
                if bool(live.all()):
                    params, opt, l = step(params, opt, reals[:, t],
                                          fakes[:, t], lrs, step_keys)
                elif not bool(live.any()):
                    l = torch.zeros(c, dtype=torch.float32, device=dev)
                else:
                    # only the clients whose slot is set take the step: a
                    # padding slot computes nothing and launches no kernel
                    idx = live.nonzero()[:, 0]
                    rows = idx.to(dev)
                    new_p, new_o, got = step(
                        _rows(params, rows), _rows(opt, rows), reals[rows, t],
                        fakes[rows, t], lrs[rows],
                        [step_keys[i] for i in idx.tolist()])
                    params = _put_rows(params, rows, new_p)
                    opt = _put_rows(opt, rows, new_o)
                    l = torch.zeros(c, dtype=got.dtype, device=dev
                                    ).index_copy(0, rows, got)
                losses.append(l)
        return params, opt, torch.stack(losses, dim=1)


_DEFAULT_KEY = keys.root(keys.DEFAULT, 0)
_fold_in = keys.fold_in


def _rows(tree, rows: torch.Tensor):
    """The clients ``rows`` of every leaf of a stacked tree."""
    return tree_map(lambda a: a.index_select(0, rows), tree)


def _put_rows(tree, rows: torch.Tensor, sub):
    """A stacked tree with the clients ``rows`` replaced by ``sub``'s."""
    return tree_map(lambda a, s: a.index_copy(0, rows, s.to(a.dtype)),
                    tree, sub)


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
    listed clients' local rounds (per-client loops, or one stacked step a
    batch per split signature under the vectorized backend) and returns
    pure :class:`ClientResult` objects.

    ``sample(cid, steps) -> (reals, fakes)`` is called once per execution
    in schedule order, so the host-RNG stream is the same under both
    backends and, under sync scheduling, the sequential trainer's.
    Optimizer state reads go through a per-round overlay so a re-run of the
    same client chains without mutating the trainer's committed state.
    ``round_key`` (a :mod:`repro_torch.keys` key, None when the program
    draws no noise) roots every execution's noise key.
    """

    def __init__(self, program: LocalProgram, *, backend: str,
                 sample: Callable[[str, int],
                                  Tuple[torch.Tensor, torch.Tensor]],
                 opt_lookup: Callable[[str], Any], default_steps: int,
                 hyper: Optional[Dict[str, ClientHyper]] = None,
                 round_key: Optional[keys.Key] = None, mesh=None,
                 cohort_of: Optional[Callable[[str], int]] = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one "
                             f"of {BACKENDS}")
        self.program = program
        self.backend = backend
        self.sample = sample
        self.opt_lookup = opt_lookup
        self.default_steps = int(default_steps)
        self.hyper = hyper or {}
        self.round_key = round_key
        # client mesh (launch/mesh.make_client_mesh): under the vectorized
        # backend a signature group whose client count the mesh divides
        # runs in contiguous per-device chunks.  None: the trainer's device
        self.mesh = mesh
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
        index, execution index) — deterministic per schedule, the same
        under both backends, and distinct across clients (the roster index
        alone is unique)."""
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

    def _shard_stacked(self, trees) -> List[Tuple[torch.device, int, int,
                                                  Tuple[Any, ...]]]:
        """Place stacked per-client trees on the mesh's ``clients`` axis:
        ``[(device, lo, hi, trees' rows lo:hi on device)]``, contiguous
        chunks in client order.  A client count the mesh does not divide
        (``sharding/specs.logical_spec``'s replicate) runs whole on the
        trees' own device."""
        from repro_torch.sharding.specs import client_chunks
        n = int(leaves(trees[0])[0].shape[0])
        chunks = None if self.mesh is None else client_chunks(self.mesh, n)
        if chunks is None:
            return [(leaves(trees[0])[0].device, 0, n, tuple(trees))]
        return [(dev, lo, hi, tuple(
            tree_map(lambda x: x[lo:hi].to(dev), t) for t in trees))
            for dev, lo, hi in chunks]

    def run(self, cids: List[str], start_params) -> List[ClientResult]:
        if not cids:
            return []
        with span("client"):
            if self.backend == "vectorized":
                return self._run_vectorized(cids, start_params)
            return self._run_looped(cids, start_params)

    def _run_looped(self, cids: List[str], start_params
                    ) -> List[ClientResult]:
        out = []
        for cid in cids:
            steps = self.steps_for(cid)
            with span("sample", client=cid):
                reals, fakes = self.sample(cid, steps)
            with span("group", client=cid):
                params, opt, losses = self.program.run_looped(
                    start_params, self._opt_for(cid), reals, fakes,
                    lr=self.lr_for(cid), key=self._key_for(cid), cid=cid)
            self._opt_overlay[cid] = opt
            out.append(ClientResult(cid, params, opt,
                                    {"losses": losses, "steps": steps}))
        return out

    def _run_vectorized(self, cids: List[str], start_params
                        ) -> List[ClientResult]:
        steps = [self.steps_for(cid) for cid in cids]
        t_max = max(steps)
        reals_l, fakes_l = [], []
        for cid, s in zip(cids, steps):
            with span("sample", client=cid):
                # exactly `s` batches, the loop's host-RNG draws; padding
                # slots are zeros under a False mask
                r, f = self.sample(cid, s)
                if s < t_max:
                    pad = lambda x: torch.cat([x, x.new_zeros(  # noqa: E731
                        (t_max - s,) + tuple(x.shape[1:]))])
                    r, f = pad(r), pad(f)
                reals_l.append(r)
                fakes_l.append(f)
        client_keys = [self._key_for(cid) for cid in cids]
        if client_keys[0] is None:
            client_keys = [_DEFAULT_KEY] * len(cids)
        # one stacked dispatch per split signature (monolithic clients are
        # the None group).  Sampling and keys above ran in schedule order,
        # so grouping reorders only the dispatch
        groups: Dict[Any, List[int]] = {}
        for i, cid in enumerate(cids):
            groups.setdefault(self.program.signature_for(cid), []).append(i)
        home = leaves(start_params)[0].device
        out: List[Optional[ClientResult]] = [None] * len(cids)
        for sig, idxs in groups.items():
            with span("group", clients=len(idxs)):
                mask = torch.tensor([[t < steps[i] for t in range(t_max)]
                                     for i in idxs], dtype=torch.bool)
                stacked = (stack_trees([start_params] * len(idxs)),
                           stack_trees([self._opt_for(cids[i]) for i in idxs]),
                           torch.stack([reals_l[i] for i in idxs]),
                           torch.stack([fakes_l[i] for i in idxs]))
                parts = []
                for dev, lo, hi, (p, o, r, f) in self._shard_stacked(stacked):
                    sub = idxs[lo:hi]
                    parts.append(self.program.run_vectorized(
                        p, o, r, f, lrs=[self.lr_for(cids[i]) for i in sub],
                        keys=[client_keys[i] for i in sub], mask=mask[lo:hi],
                        signature=sig))
                if len(parts) == 1:
                    new_p, new_o, losses = parts[0]
                else:               # the chunks back on the trainer's device
                    new_p, new_o, losses = (tree_map(
                        lambda *xs: torch.cat([x.to(home) for x in xs]), *got)
                        for got in zip(*parts))
                losses = losses.tolist()
                for j, i in enumerate(idxs):
                    cid, s = cids[i], steps[i]
                    p = tree_map(lambda x: x[j], new_p)
                    o = tree_map(lambda x: x[j], new_o)
                    self._opt_overlay[cid] = o
                    out[i] = ClientResult(cid, p, o, {"losses": losses[j][:s],
                                                      "steps": s})
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
