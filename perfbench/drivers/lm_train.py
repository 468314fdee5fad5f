"""Driver of a language model's training step:
``repro_torch.runtime.train.make_train_step``, one call a step, built from
a configuration file.

Set-up makes the weights (one generator a leaf, on the device, so any
leaf can be drawn again alone) and the token batches from the seed, builds
the step with its optimizer (wrapped so that a traced run can time each
``Optimizer.update``) and drives it through the first ``check_steps``
steps on distinct batches, recording each step's loss, after the first
step each leaf's first moment over ``1 - beta1`` (the clipped gradient the
optimizer took), and after the last each leaf's change.  The window runs
the same step on.
"""
from __future__ import annotations

import gc
import math
import types
from typing import Any, Dict, Optional, Tuple

import torch

from perfbench import flops
from perfbench.common import (Marks, generator, leaf_norms, named_leaves,
                              reference, subseed)

STACKED = ("stack/",)


def port_overrides(config: Dict[str, Any]) -> Dict[str, Any]:
    moe_keys = ("num_experts", "num_shared_experts", "top_k", "d_ff_expert",
                "router_aux_coef", "capacity_factor")
    over: Dict[str, Any] = {}
    for k, v in config["model"].items():
        over[f"model.moe.{k}" if k in moe_keys else f"model.{k}"] = v
    over.update({f"parallel.{k}": v for k, v in config["parallel"].items()})
    over.update({f"optim.{k}": v for k, v in config["optim"].items()})
    return over


def param_shapes(m: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Each weight of a decoder-only MoE model with qk-norm: its shape
    and its initialisation (``normal:<scale>`` or ``ones``).  Layers are
    stacked on a leading axis under ``stack/b0``."""
    d, n, e = m["d_model"], m["num_layers"], m["num_experts"]
    q, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    ff, hd, v = m["d_ff_expert"], m["head_dim"], m["vocab_size"]
    b = "stack/b0/"
    return {
        "embed/table": ((v, d), "normal:0.02"),
        "final_norm/scale": ((d,), "ones"),
        "head/w": ((d, v), f"normal:{d ** -0.5}"),
        b + "attn/k_norm/scale": ((n, hd), "ones"),
        b + "attn/q_norm/scale": ((n, hd), "ones"),
        b + "attn/wk/w": ((n, d, kv), f"normal:{d ** -0.5}"),
        b + "attn/wo/w": ((n, q, d), f"normal:{q ** -0.5}"),
        b + "attn/wq/w": ((n, d, q), f"normal:{d ** -0.5}"),
        b + "attn/wv/w": ((n, d, kv), f"normal:{d ** -0.5}"),
        b + "ln1/scale": ((n, d), "ones"),
        b + "ln2/scale": ((n, d), "ones"),
        b + "mlp/experts/down": ((n, e, ff, d), f"normal:{ff ** -0.5}"),
        b + "mlp/experts/gate": ((n, e, d, ff), f"normal:{d ** -0.5}"),
        b + "mlp/experts/up": ((n, e, d, ff), f"normal:{d ** -0.5}"),
        b + "mlp/router/w": ((n, d, e), "normal:0.02"),
    }


class Weights:
    """The initial weights of a run: leaf ``i`` (sorted by name) from its
    own generator, so it can be drawn again without the others."""

    def __init__(self, m: Dict[str, Any], seed: int, device):
        self.shapes = param_shapes(m)
        self.names = sorted(self.shapes)
        self.seed, self.device = seed, device

    def leaf(self, name: str) -> torch.Tensor:
        shape, init = self.shapes[name]
        if init == "ones":
            return torch.ones(shape, device=self.device)
        g = torch.Generator(device=self.device)
        g.manual_seed(subseed(self.seed, 7, self.names.index(name)))
        x = torch.randn(shape, generator=g, device=self.device)
        return x.mul_(float(init.split(":")[1]))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"tail": {}}
        for name in self.names:
            cur = out
            parts = name.split("/")
            for k in parts[:-1]:
                cur = cur.setdefault(k, {})
            cur[parts[-1]] = self.leaf(name)
        return out


def to_pinned_host(leaves: Dict[str, torch.Tensor], scale: float
                   ) -> Dict[str, torch.Tensor]:
    """``scale`` x each leaf, copied into one page-locked host buffer
    (views of it), one leaf at a time so that the device holds one scaled
    leaf at most: a pageable copy of the LM's 7.5 GB took 3.7 s."""
    if not leaves or next(iter(leaves.values())).device.type != "cuda":
        return {n: (t.detach() * scale).cpu() for n, t in leaves.items()}
    total = sum(t.numel() for t in leaves.values())
    buf = torch.empty(total, dtype=torch.float32, pin_memory=True)
    out, at = {}, 0
    for n, t in leaves.items():
        view = buf[at:at + t.numel()].view(t.shape)
        view.copy_(t.detach() * scale, non_blocking=True)
        out[n] = view
        at += t.numel()
    torch.cuda.synchronize()
    return out


class Session:
    """One train step, its parameters and optimizer state, driven from the
    seed; ``step()`` is one training step."""

    unit = "step"

    def __init__(self, spec: Dict[str, Any], seed: int, device,
                 program: bool = True):
        marks = self.marks = Marks()
        from repro_torch.configs.registry import get_config
        from repro_torch.optim.optimizers import Optimizer
        import repro_torch.runtime.train as rt
        marks.mark("import")

        self.config, self.traffic = spec["config"], spec["traffic"]
        self.seed, self.device = int(seed), torch.device(device)
        m = self.config["model"]
        over = port_overrides(self.config)
        over.update({"shape.seq_len": self.traffic["seq_len"],
                     "shape.global_batch": self.traffic["batch"]})
        self.cfg = get_config(self.config["arch"]).override(over)
        self.weights = Weights(m, seed, self.device)
        self.tokens = generator(self.traffic["generator"])(
            self.traffic, seed, m["vocab_size"], self.device)
        marks.mark("inputs")
        self.k = 0
        self.record: Dict[str, Any] = {"losses": []}
        if not program:          # inputs only: for the reference's control
            return
        self.hook = types.SimpleNamespace()
        made = rt.make_optimizer

        def make(ocfg, hook=self.hook):
            opt = made(ocfg)
            hook.update, hook.init = opt.update, opt.init
            return Optimizer(init=opt.init,
                             update=lambda *a: hook.update(*a))
        rt.make_optimizer = make
        try:
            self.train_step = rt.make_train_step(self.cfg)
        finally:
            rt.make_optimizer = made
        marks.mark("build")
        self.params = self.weights.tree()
        self.opt = self.hook.init(self.params)
        marks.mark("weights")
        b1 = float(self.config["optim"]["beta1"])
        for s in range(int(self.traffic["check_steps"])):
            loss = self._run()
            self.record["losses"].append(float(loss))
            marks.mark(f"step{s}")
            if s == 0:
                self.record["grad1"] = {
                    k: v / (1.0 - b1) for k, v in leaf_norms(
                        self.opt["m"], split_stacked=STACKED).items()}
                # the first gradient itself, on the host, for the
                # reference to take the difference with
                self.grad1_host = to_pinned_host(
                    dict(named_leaves(self.opt["m"])), 1.0 / (1.0 - b1))
                marks.mark("grad1_to_host")
        self.record["change3"] = self.change_norms()
        marks.mark("records")

    def batch(self, s: int) -> Dict[str, torch.Tensor]:
        t = self.tokens[s % self.tokens.shape[0]]
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def _run(self) -> torch.Tensor:
        self.params, self.opt, met = self.train_step(
            self.params, self.opt, self.batch(self.k), self.k)
        self.k += 1
        return met["loss"]

    def change_norms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, leaf in named_leaves(self.params):
            diff = leaf.detach().to(torch.float32) - self.weights.leaf(name)
            if name.startswith(STACKED):
                out.update({f"{name}[{i}]": v for i, v in enumerate(
                    torch.linalg.vector_norm(diff.flatten(1), dim=1)
                    .cpu().tolist())})
            else:
                out[name] = float(torch.linalg.vector_norm(diff))
            del diff
        return out

    # -- the window ---------------------------------------------------------
    def step(self) -> bool:
        return math.isfinite(float(self._run()))

    def tokens_per_step(self) -> int:
        return int(self.traffic["batch"]) * int(self.traffic["seq_len"])

    def span_points(self):
        return [("optim", self.hook, "update")]

    def model_flops_per_step(self) -> float:
        return flops.lm_train_step(self.config["model"],
                                   batch=int(self.traffic["batch"]),
                                   seq_len=int(self.traffic["seq_len"]))

    def dp_clip_shape(self) -> Optional[Tuple[int, int]]:
        return None

    # -- after the window ---------------------------------------------------
    def release(self) -> None:
        self.params = self.opt = self.train_step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_record(self, lowp: bool = False, other=None,
                         keep: bool = False) -> Dict[str, Any]:
        """The reference's record from this run's inputs; its first
        gradient is differenced with ``other`` (default: the program's);
        ``keep`` returns the reference's own under ``kept``."""
        ref = reference(self.config["name"])
        batches = [self.batch(s)
                   for s in range(int(self.traffic["check_steps"]))]
        if other is None:
            other = getattr(self, "grad1_host", None)
        return ref.run(self.config, self.weights, batches,
                       device=self.device, lowp=lowp, other_grad1=other,
                       keep=keep)
