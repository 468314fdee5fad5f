"""Training-step builders (port of ``repro/runtime/train.py``).

Two step shapes:

  * ``make_train_step``      standard training: the batch split into
                             ``parallel.microbatches`` pieces, their
                             gradients summed in ``parallel.accum_dtype``
                             and divided by their count, then one
                             optimizer update at the schedule's lr (the
                             paper's ``local_steps=1`` case).
  * ``make_fsl_train_step``  FSL mode: one model replica per FL client
                             (a leading client axis on every parameter and
                             optimizer leaf), each taking the standard step
                             on its own slice of the batch, and every
                             ``fsl.local_steps`` steps the replicas are
                             replaced by their float32 mean (FedAvg; the
                             optimizer state is not averaged).

Gradients come from ``torch.autograd.grad`` over the parameter leaves: the
layer stack's ``remat`` checkpoints (non-reentrant) do not compose with
``torch.func`` transforms.  The reference's ``lax.scan`` over
micro-batches is a Python loop here, and its ``jax.vmap`` over clients a
loop that writes each client's result into fresh stacked leaves; both are
the same arithmetic, and a client's slice equals a lone step on it bit for
bit.

The reference's hand-written kernels are forward-only (they define no
VJP, and ``jax.grad`` through its flash op fails), and so are the port's
flash_attention and wkv6 kernels: a config that asks for them
(``parallel.use_flash_kernel``) is refused when the step is built, and
training runs the plain WKV scan.  Attention goes through
``models.layers.attention``, which sends bf16 self-attention at an
instantiated head_dim on the card to the training flash op
(``kernels/flash_attention/train.py``, forward and backward) and every
other call to the plain path.

Steps run where the parameters live; ``update`` returns new trees and the
inputs are never written.

Host spans (``repro_torch/obs/trace.py``, recorded under an active
tracer): ``step`` is one standard step, indexed by its ``step_idx``;
inside it ``microbatch`` is one micro-batch's forward and backward,
``accumulate`` the accumulators' work (their zero fill, each
micro-batch's adds, the final divide) and ``optim`` the schedule and the
optimizer update; inside ``microbatch`` the layers' own spans (``mla``,
``moe``).  The MoE layers' counters are read once a step, when ``step``
closes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.config import RunConfig
from repro_torch.models.transformer import lm_loss
from repro_torch.obs.trace import span
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedule import make_schedule
from repro_torch.runtime.serve import _dtype
from repro_torch.tree import leaves, tree_map, unflatten_like


def make_train_step(cfg: RunConfig) -> Callable:
    """-> step(params, opt_state, batch, step_idx) -> (params, opt, metrics).

    ``metrics``: ``loss`` and ``aux_loss`` (the micro-batches' means) and
    ``lr``, 0-d float32 tensors."""
    if cfg.parallel.use_flash_kernel:
        raise ValueError(
            "parallel.use_flash_kernel: the flash_attention and wkv6 kernels "
            "are forward-only (no VJP, as in the reference, which trains "
            "through the plain paths); build the train step with "
            "use_flash_kernel=False")
    m = cfg.model
    par = cfg.parallel
    opt = make_optimizer(cfg.optim)
    sched = make_schedule(cfg.optim.schedule, cfg.optim.lr,
                          cfg.optim.warmup_steps, cfg.optim.total_steps)
    cd = _dtype(par.compute_dtype)
    acc_dt = _dtype(par.accum_dtype)
    nmb = max(1, par.microbatches)

    def loss_fn(params, mb):
        return lm_loss(params, mb, m, cd, par.remat, False,
                       scan_layers=par.scan_layers)

    def train_step(params, opt_state, batch, step_idx):
        bsz = batch["tokens"].shape[0]
        if bsz % nmb:
            raise ValueError(f"batch {bsz} does not split into "
                             f"{nmb} micro-batches")
        with span("step", index=step_idx):
            return run_step(params, opt_state, batch, step_idx, bsz)

    def run_step(params, opt_state, batch, step_idx, bsz):
        mbs = tree_map(lambda x: x.reshape(nmb, bsz // nmb, *x.shape[1:]),
                       batch)
        flat = leaves(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        live_tree = unflatten_like(params, live)
        dev = flat[0].device
        with span("accumulate"):
            gacc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                    for p in flat]
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            auxsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(nmb):
            mb = tree_map(lambda x: x[i], mbs)
            with span("microbatch"), torch.enable_grad():
                loss, metrics = loss_fn(live_tree, mb)
                grads = torch.autograd.grad(loss, live,
                                            materialize_grads=True)
            with span("accumulate"):
                for a, g in zip(gacc, grads):
                    a.add_(g.to(a.dtype))
                del grads, loss
                lsum = lsum + metrics["loss"].detach()
                auxsum = auxsum + metrics["aux_loss"].detach()
        del live, live_tree
        with span("accumulate"):
            # divided in place, by a tensor: CUDA divides by a Python
            # number as a multiply by its rounded reciprocal
            div = torch.tensor(float(nmb), dtype=acc_dt, device=dev)
            grads = unflatten_like(params, [a.div_(div) for a in gacc])
            del gacc
            div = div.to(torch.float32)
            loss, aux = lsum / div, auxsum / div
        with span("optim"):
            lr = sched(step_idx)
            params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss, "aux_loss": aux, "lr": lr}

    return train_step


def _avg_all(tree):
    """Each leaf replaced by its float32 mean over the client axis,
    broadcast back and cast to the leaf's dtype."""
    return tree_map(
        lambda x: torch.mean(x.to(torch.float32), dim=0, keepdim=True)
        .expand(x.shape).to(x.dtype).contiguous(), tree)


def make_fsl_train_step(cfg: RunConfig, num_clients: int) -> Callable:
    """FSL-mode step over stacked per-client replicas.

    params/opt leaves carry a leading (num_clients,) axis; batch leaves a
    leading client axis. Every ``cfg.fsl.local_steps`` steps the replicas
    are FedAvg'd (uniform mean — weighted form in core.fedavg); the
    metrics are the clients' means."""
    base_step = make_train_step(cfg)
    local_steps = max(1, cfg.fsl.local_steps)

    def fsl_step(cparams, copt, cbatch, step_idx
                 ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        out_p = tree_map(torch.empty_like, cparams)
        out_o = tree_map(torch.empty_like, copt)
        mets = []
        for c in range(num_clients):
            p, o, met = base_step(tree_map(lambda x: x[c], cparams),
                                  tree_map(lambda x: x[c], copt),
                                  tree_map(lambda x: x[c], cbatch),
                                  step_idx)
            tree_map(lambda dst, src: dst[c].copy_(src), out_p, p)
            tree_map(lambda dst, src: dst[c].copy_(src), out_o, o)
            mets.append(met)
            del p, o
        if (int(step_idx) + 1) % local_steps == 0:
            out_p = _avg_all(out_p)
        metrics = {k: torch.mean(torch.stack([mt[k] for mt in mets]))
                   for k in mets[0]}
        return out_p, out_o, metrics

    return fsl_step
