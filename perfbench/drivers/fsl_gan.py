"""Driver of the FSL-GAN round: ``repro_torch.core.gan.FSLGANTrainer``,
one ``train_epoch`` a step, built from a configuration file and a traffic
mix's path settings.

Set-up makes the client images and both models' weights from the seed,
hands them to one trainer, and drives that trainer through the first
``check_steps`` rounds (which also warm up every shape the window uses).
It records each round's losses, after the first round each leaf's first
moment as the Adam states hold it, and after the last each leaf's change;
the window then runs the same trainer on.
"""
from __future__ import annotations

import gc
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench import flops
from perfbench.common import (Marks, generator, leaf_norms, named_leaves,
                              reference, subseed)


def port_overrides(config: Dict[str, Any], path: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """The port's dotted config overrides for one configuration file and
    one traffic mix's path settings."""
    over: Dict[str, Any] = {f"model.dcgan.{k}": v
                            for k, v in config["model"].items()}
    over.update({f"fsl.{k}": v for k, v in config["fsl"].items()})
    over.update({f"optim.{k}": v for k, v in config["optim"].items()})
    over["shape.global_batch"] = config["batch"]
    over.update(path)
    return over


def noise_seeds(seed: int) -> Dict[str, int]:
    """The DP-SGD and stage noise streams of a run, from its seed."""
    return {"privacy.seed": subseed(seed, 4) % 2**62,
            "split.seed": subseed(seed, 6) % 2**62}


def init_weights(config: Dict[str, Any], seed: int, device
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """G and D weights drawn on ``device`` from the seed, one call a
    leaf, at the DCGAN initialisation's scales: convolutions
    ``0.7 (2 / fan_in)^0.5``, dense layers ``fan_in^-0.5``, biases 0,
    batch-norm scales 1 and biases 0.  Kernels are HWIO."""
    m = config["model"]
    f, lat, ch = m["base_filters"], m["latent_dim"], m["channels"]
    s0 = m["image_size"] // 4
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, 5))

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=device) * scale

    def conv(cin, cout):
        return {"w": normal((5, 5, cin, cout), (2.0 / (25 * cin)) ** 0.5 * 0.7),
                "b": torch.zeros(cout, device=device)}

    def bn(c):
        return {"scale": torch.ones(c, device=device),
                "bias": torch.zeros(c, device=device)}

    d: Dict[str, Any] = {}
    cin, size = ch, m["image_size"]
    for i in range(m["conv_blocks"]):
        cout = f * 2 ** i
        d[f"conv{i}"] = conv(cin, cout)
        if i > 0:
            d[f"conv{i}"]["bn"] = bn(cout)
        cin, size = cout, -(-size // 2)
    n_in = size * size * cin
    d["classifier"] = {"w": normal((n_in, 1), n_in ** -0.5),
                       "b": torch.zeros(1, device=device)}
    gp = {"proj": {"w": normal((lat, s0 * s0 * f * 4), lat ** -0.5),
                   "b": torch.zeros(s0 * s0 * f * 4, device=device),
                   "bn": bn(f * 4)},
          "deconv0": {**conv(f * 4, f * 2), "bn": bn(f * 2)},
          "deconv1": {**conv(f * 2, f), "bn": bn(f)},
          "out": conv(f, ch)}
    return gp, d


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class Session:
    """One trainer, driven from the seed; ``step()`` is one round."""

    unit = "round"

    def __init__(self, spec: Dict[str, Any], seed: int, device,
                 program: bool = True):
        marks = self.marks = Marks()
        from repro_torch.configs.registry import get_config
        from repro_torch.core.gan import FSLGANTrainer
        marks.mark("import")

        self.config, self.traffic = spec["config"], spec["traffic"]
        self.seed, self.device = int(seed), torch.device(device)
        over = port_overrides(self.config, self.traffic["path"])
        over.update(noise_seeds(seed))
        self.cfg = get_config(self.config["arch"]).override(over)
        m = self.config["model"]
        self.clients = [f"c{i}" for i in
                        range(self.config["fsl"]["num_clients"])]
        self.data = generator(self.traffic["generator"])(
            self.traffic["images"] | {"images_per_client":
                                      self.config["examples_per_client"]},
            seed, self.clients,
            (m["image_size"], m["image_size"], m["channels"]))
        marks.mark("inputs")
        self.batches = int(self.traffic["batches_per_client"])
        self.trainer_seed = subseed(seed, 3)
        g0, d0 = init_weights(self.config, seed, self.device)
        self.p0 = {"G": _clone(g0), "D": _clone(d0)}
        self.record: Dict[str, Any] = {"losses": []}
        marks.mark("weights")
        if not program:          # inputs only: for the reference's control
            return
        tr = FSLGANTrainer(self.cfg, self.data, seed=self.trainer_seed,
                           device=self.device)
        st = tr.state
        st.g_params = g0
        st.g_opt = tr.g_optimizer.init(g0)
        st.d_params = {cid: _clone(d0) for cid in tr.client_ids}
        st.d_opt = {cid: tr.d_optimizer.init(d0) for cid in tr.client_ids}
        self.trainer = tr
        marks.mark("trainer")
        for r in range(int(self.traffic["check_steps"])):
            out = tr.train_epoch(batches_per_client=self.batches)
            marks.mark(f"round{r}")
            self.record["losses"] += [out["d_loss"], out["g_loss"]]
            if r == 0:
                self.record["grad1"] = self.first_moments()
                # each client's first D step: its loss at the initial weights
                self.record["first_losses"] = [
                    info["losses"][0]
                    for _, info in tr.engine.last_report.client_infos]
                # G and the averaged D after the round, for the reference
                # to take the difference with
                self.state1_host = {
                    **{n: t.detach().cpu() for n, t in
                       named_leaves(st.g_params, "G")},
                    **{n: t.detach().cpu() for n, t in
                       named_leaves(st.d_params[self.clients[0]], "D")}}
            marks.mark("records")
        self.record["change3"] = {
            **leaf_norms(_diff(st.g_params, self.p0["G"]), "G"),
            **leaf_norms(_diff(st.d_params[self.clients[0]],
                               self.p0["D"]), "D")}
        marks.mark("records")

    def first_moments(self) -> Dict[str, float]:
        st = self.trainer.state
        out = leaf_norms(st.g_opt["m"], "G")
        for i, cid in enumerate(self.clients):
            out.update(leaf_norms(st.d_opt[cid]["m"], f"D{i}"))
        return out

    # -- the window ---------------------------------------------------------
    def step(self) -> bool:
        """One round; False when its losses are not finite."""
        out = self.trainer.train_epoch(batches_per_client=self.batches)
        return math.isfinite(out["d_loss"]) and math.isfinite(out["g_loss"])

    def tokens_per_step(self) -> int:
        return 0

    def span_points(self) -> List[Tuple[str, Any, str]]:
        from repro_torch.fed.programs import RoundExecutor
        return [("client", RoundExecutor, "run")]

    def model_flops_per_step(self) -> float:
        m = self.config["model"]
        return flops.fsl_gan_round(
            m, batch=self.config["batch"], clients=len(self.clients),
            steps=self.batches)

    def dp_clip_shape(self) -> Optional[Tuple[int, int]]:
        if not (self.cfg.privacy.enabled and self.cfg.privacy.mode == "dp_sgd"
                and self.cfg.privacy.use_kernel):
            return None
        n = sum(t.numel() for t in _leaves(self.p0["D"]))
        return int(self.config["batch"]), int(n)

    # -- after the window ---------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_record(self, lowp: bool = False, other=None,
                         keep: bool = False) -> Dict[str, Any]:
        """The reference's record from this run's inputs; its G and
        averaged D after the first round are differenced with ``other``
        (default: the program's); ``keep`` returns its own under
        ``kept``."""
        ref = reference(self.config["name"])
        if other is None:
            other = getattr(self, "state1_host", None)
        return ref.run(self.config, self.traffic, self.cfg_view(),
                       self.p0, self.data, self.trainer_seed,
                       steps=int(self.traffic["check_steps"]),
                       device=self.device, lowp=lowp, other_state1=other,
                       keep=keep)

    def cfg_view(self) -> Dict[str, Any]:
        """The settings the reference follows: the traffic's path settings
        and this run's noise seeds, as plain values."""
        return {**self.traffic["path"], **noise_seeds(self.seed)}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _diff(a, b):
    if isinstance(a, dict):
        return {k: _diff(a[k], b[k]) for k in a}
    return a.detach().to(torch.float32) - b.to(torch.float32)
