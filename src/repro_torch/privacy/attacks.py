"""Honest-but-curious attacks on the artifacts the fed runtime ships.  Port
of ``repro/privacy/attacks.py``.

The paper's privacy claim is that raw data never leaves the device — only
(a) discriminator parameters/deltas go up the WAN and (b) split-boundary
activations hop the LAN between a client's devices.  Following *Evaluating
Privacy Leakage in Split Learning* (Qiu et al.) and PS-FedGAN (Wijesinghe
et al.), this module measures what each artifact gives away:

  * :func:`invert_gradients` — DLG-style gradient inversion (Zhu et al.
    2019; cosine matching per Geiping et al. 2020): the server knows the
    global D it broadcast, the fakes it shipped, and the uplinked delta;
    it optimizes dummy "real" images until the simulated local gradient
    matches the observed one.  The objective is the gradient of a
    gradient: each step differentiates the D loss with respect to the D
    parameters with ``create_graph=True``, then the cosine with respect to
    the images.
  * :class:`ActivationInversionAttack` — a decoder trained on auxiliary
    data to invert the smashed activations crossing one split boundary
    (the LAN surface inside a client).  :func:`make_shipped_prefix_fn`
    targets the tensors an *executed* split round actually ships —
    post-boundary-stage (codec/DP, through the boundary_fuse CUDA kernel
    with ``split.use_kernel``), via ``core/split.SplitExecution`` — while
    :func:`make_prefix_fn` keeps the clean-prefix probe for depth sweeps.
  * :func:`membership_inference` — threshold attack on the trained D
    (Yeom et al. 2018): D's realness logit is systematically higher on its
    own training reals than on held-out reals.

Images are NHWC and decoder kernels HWIO, as everywhere in the port.  Every
entry point that runs convolutions computes them in float32
(:func:`repro_torch.device.fp32_convolutions`): on the card TF32 would move
a gradient of a gradient far from the float32 result.  Images and
activations may be numpy arrays or tensors; they are computed on the
device of the parameters (the decoder's: the attack's ``device``).

The reference draws its random starts from ``jax.random`` keys; the port's
come from :mod:`repro_torch.keys` paths and ``torch.Generator`` seeds, so
the draws differ by construction.  Given the same starting images and
decoder parameters, the attacks compute what the reference computes.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import keys
from repro_torch.device import fp32_convolutions, resolve_device
from repro_torch.models.dcgan import (disc_apply, disc_apply_layer,
                                      disc_layer_names)
from repro_torch.optim.optimizers import adamw
from repro_torch.privacy.metrics import attack_advantage, attack_auc
from repro_torch.tree import leaves, tree_map, value_and_grad

# loss_fn(params, real_batch, fake_batch) -> scalar  (the D loss the victim
# trains with; core/gan.d_loss_fn partial-applied over the model config)
DLossFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]


def _on(x, device) -> torch.Tensor:
    """``x`` (array or tensor) as float32 on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _device_of(params) -> torch.device:
    return leaves(params)[0].device


# ---------------------------------------------------------------------------
# gradient inversion of the uplinked discriminator delta
# ---------------------------------------------------------------------------

def flat_grads(tree) -> torch.Tensor:
    """Every leaf flattened to float32 and concatenated in
    :func:`repro_torch.tree.leaves` order (``jax.tree.leaves``')."""
    return torch.cat([l.reshape(-1).to(torch.float32) for l in leaves(tree)])


def delta_to_grad(delta, lr: float):
    """One local SGD step: uplinked delta = -lr * grad, inverted exactly.
    (Adam deltas only preserve direction — feed them to the cosine
    objective as-is instead.)"""
    return tree_map(lambda d: -d.to(torch.float32) / lr, delta)


def _total_variation(x: torch.Tensor) -> torch.Tensor:
    return (torch.mean(torch.abs(x[:, 1:] - x[:, :-1]))
            + torch.mean(torch.abs(x[:, :, 1:] - x[:, :, :-1])))


@fp32_convolutions()
def invert_gradients(loss_fn: DLossFn, d_params, target_grads, fakes,
                     batch_shape: Tuple[int, ...], *, steps: int = 300,
                     lr: float = 0.1, tv_weight: float = 1e-3,
                     key: Optional[keys.Key] = None, x0=None
                     ) -> Tuple[torch.Tensor, List[float]]:
    """Reconstruct the victim's real batch from an observed D gradient.

    ``target_grads``: the gradient tree the server inferred from the uplink
    (see :func:`delta_to_grad`).  ``batch_shape``: (B, H, W, C) of the batch
    being reconstructed.  Minimizes 1 - cos(sim_grad, target) + TV prior
    with Adam, projecting onto the valid [-1, 1] image box each step.  The
    start is ``x0``, or 0.1 x a standard normal drawn from the noise key
    ``key`` (default ``keys.root(keys.DEFAULT, 0)``).  Runs on the device
    of ``d_params``.

    Returns (reconstructed batch, matching-loss history).
    """
    dev = _device_of(d_params)
    tgt = flat_grads(target_grads).to(dev)
    tgt_norm = torch.linalg.norm(tgt)
    fakes = _on(fakes, dev)
    params = tree_map(lambda p: p.detach().requires_grad_(True), d_params)
    plist = leaves(params)

    def match_loss(x):
        g = torch.autograd.grad(loss_fn(params, x, fakes), plist,
                                create_graph=True)
        gv = torch.cat([t.reshape(-1).to(torch.float32) for t in g])
        cos = torch.dot(gv, tgt) / torch.clamp(
            torch.linalg.norm(gv) * tgt_norm, min=1e-12)
        return (1.0 - cos) + tv_weight * _total_variation(x)

    opt = adamw(0.9, 0.999, 1e-8)
    if x0 is None:
        key = keys.root(keys.DEFAULT, 0) if key is None else key
        x = 0.1 * keys.normal(key, batch_shape, dev)
    else:
        x = _on(x0, dev)
    state = opt.init(x)
    history: List[float] = []
    with torch.enable_grad():
        for _ in range(steps):
            x = x.detach().requires_grad_(True)
            loss = match_loss(x)
            (g,) = torch.autograd.grad(loss, x)
            x, state = opt.update(g, state, x.detach(), lr)
            x = torch.clamp(x, -1.0, 1.0)
            history.append(float(loss.detach()))
    return x.detach(), history


# ---------------------------------------------------------------------------
# activation inversion at a split boundary
# ---------------------------------------------------------------------------

def make_prefix_fn(d_params, c, depth: int):
    """Apply the first ``depth`` discriminator layers: the activation a
    device at that boundary sees. depth=1 => output of conv0, etc."""
    names = disc_layer_names(c)[:depth]
    dev = _device_of(d_params)

    @fp32_convolutions()
    @torch.no_grad()
    def prefix(x):
        x = _on(x, dev)
        for n in names:
            x = disc_apply_layer(n, d_params, x, c)
        return x

    return prefix


def plan_boundary_depths(plan) -> List[int]:
    """Layer depths at which this plan's activations cross devices (the
    LAN hops an on-path device can observe)."""
    depths, li = [], 0
    for a, b in zip(plan.portions, plan.portions[1:]):
        li += len(a.layer_names)
        if a.device_id != b.device_id:
            depths.append(li)
    return depths


def make_shipped_prefix_fn(split_exec, d_params, boundary_idx: int, *,
                           key: Optional[keys.Key] = None):
    """Prefix returning what an on-path device ACTUALLY observes at
    ``boundary_idx`` during executed split training: the staged boundary
    tensor — post-codec, post-DP-noise — not a separate clean forward.

    ``split_exec`` is the ``core/split.SplitExecution`` the training step
    runs (``FSLGANTrainer.split_execs[cid]``); with ``split.use_kernel``
    each crossing of a CUDA tensor is one boundary_fuse launch, so a call
    at boundary ``b`` launches it ``b + 1`` times.  ``key`` seeds a
    stochastic stage; each call folds in a fresh counter — every
    observation is one LAN crossing with its own noise draw, so a decoder
    can never learn to subtract a single reused noise tensor.  Omitted,
    the split's default key is taken: a keyless probe must never ship
    noiseless tensors and overstate the leakage of the deployed round.
    """
    if key is None and split_exec.stochastic:
        key = split_exec._default_key(None)
    calls = itertools.count()
    dev = _device_of(d_params)

    @fp32_convolutions()
    def prefix(x):
        k = None if key is None else keys.fold_in(key, next(calls))
        return split_exec.forward_boundaries(
            d_params, _on(x, dev), key=k, upto=boundary_idx)[boundary_idx]

    return prefix


def _decoder_init(gen: torch.Generator, act_shape, out_shape,
                  width: int = 32, device: Union[str, torch.device] = "cpu"
                  ) -> Tuple[Dict[int, Dict[str, torch.Tensor]],
                             Tuple[int, ...]]:
    """Resize-conv decoder from (H', W', C') activations to (H, W, C).

    The layers are a dict keyed 0, 1, ... (the port's tree helpers walk
    dicts, and integer keys sort as the reference's list indexes).  The
    weights are drawn in layer order from ``gen`` on the CPU, then moved to
    ``device``."""
    h, cin = act_shape[0], act_shape[2]
    target_h, cout = out_shape[0], out_shape[2]
    sizes, chans = [], []
    while h < target_h:
        h = min(2 * h, target_h)
        sizes.append(h)
        chans.append(width)
    sizes.append(target_h)          # final refinement conv at full res
    chans.append(cout)
    params: Dict[int, Dict[str, torch.Tensor]] = {}
    for i, ch in enumerate(chans):
        fan = 3 * 3 * cin
        w = torch.randn((3, 3, cin, ch), generator=gen,
                        dtype=torch.float32) * (2.0 / fan) ** 0.5
        params[i] = {"w": w.to(device),
                     "b": torch.zeros((ch,), dtype=torch.float32,
                                      device=device)}
        cin = ch
    # sizes are static structure, kept apart from the trainable tree
    return params, tuple(sizes)


def _decoder_apply(layers, sizes, a: torch.Tensor) -> torch.Tensor:
    """NHWC activations -> NHWC images in (-1, 1).  Each layer resizes
    bilinearly (``jax.image.resize``'s ``"bilinear"``: the sizes only grow,
    where its renormalised edge weights and PyTorch's clamped source index
    agree), then a 3x3 stride-1 ``SAME`` convolution (pad 1 each side)."""
    x = a.to(torch.float32).permute(0, 3, 1, 2)
    n = len(layers)
    for i in range(n):
        lp = layers[i]
        if i < len(sizes):
            x = F.interpolate(x, size=(sizes[i], sizes[i]), mode="bilinear",
                              align_corners=False, antialias=False)
        x = F.conv2d(x, lp["w"].permute(3, 2, 0, 1), padding=1) \
            + lp["b"].view(1, -1, 1, 1)
        if i < n - 1:
            x = F.leaky_relu(x, 0.2)
    return torch.tanh(x).permute(0, 2, 3, 1)


class ActivationInversionAttack:
    """Decoder attack on one split boundary.

    Threat model: an on-path device (or LAN eavesdropper) observes the
    smashed activations ``prefix(x)`` and can query the prefix on auxiliary
    data of the same modality (shadow access — the weakest assumption under
    which Qiu et al.'s attack applies).  ``train`` fits the decoder on
    (prefix(aux), aux) pairs; ``reconstruct`` inverts victim activations.
    The decoder lives on ``device`` (the GPU unless the caller names
    another), where the prefix must return its activations.
    """

    def __init__(self, prefix_fn, image_shape: Tuple[int, int, int], *,
                 width: int = 32, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.prefix = prefix_fn
        self.image_shape = tuple(image_shape)
        probe = prefix_fn(torch.zeros((1,) + self.image_shape,
                                      dtype=torch.float32,
                                      device=self.device))
        self.act_shape = tuple(probe.shape[1:])
        self.dec, self.sizes = _decoder_init(
            torch.Generator().manual_seed(seed), self.act_shape,
            self.image_shape, width, self.device)
        self._opt = adamw(0.9, 0.999, 1e-8)
        self._state = self._opt.init(self.dec)

    @fp32_convolutions()
    def train(self, aux_images, *, steps: int = 200, batch: int = 32,
              lr: float = 2e-3, seed: int = 0) -> List[float]:
        """Fit the decoder: ``steps`` Adam steps on batches drawn with
        ``np.random.default_rng(seed)`` as the reference draws them; the
        activations are computed once."""
        aux = _on(aux_images, self.device)
        acts = self.prefix(aux).detach()
        sizes = self.sizes

        def loss_fn(dec, a, y):
            return torch.mean((_decoder_apply(dec, sizes, a) - y) ** 2)

        vg = value_and_grad(loss_fn)
        rng = np.random.default_rng(seed)
        history = []
        for _ in range(steps):
            idx = torch.from_numpy(
                rng.integers(0, aux.shape[0], batch)).to(self.device)
            loss, g = vg(self.dec, acts[idx], aux[idx])
            self.dec, self._state = self._opt.update(g, self._state,
                                                     self.dec, lr)
            history.append(float(loss))
        return history

    @fp32_convolutions()
    @torch.no_grad()
    def reconstruct(self, victim_images) -> torch.Tensor:
        """Invert the activations of (unseen) victim inputs."""
        return _decoder_apply(self.dec, self.sizes, self.prefix(
            _on(victim_images, self.device)))


# ---------------------------------------------------------------------------
# membership inference against the trained discriminator
# ---------------------------------------------------------------------------

@fp32_convolutions()
@torch.no_grad()
def membership_scores(d_params, x, c) -> np.ndarray:
    """Per-example realness logit — D's confidence the example is from its
    training distribution (the MIA score)."""
    logits = disc_apply(d_params, _on(x, _device_of(d_params)), c)
    return logits[:, 0].cpu().numpy()


def membership_inference(d_params, c, member_x, nonmember_x
                         ) -> Dict[str, float]:
    """Yeom-style threshold attack: returns auc, advantage, threshold."""
    ms = membership_scores(d_params, member_x, c)
    ns = membership_scores(d_params, nonmember_x, c)
    adv, thr = attack_advantage(ms, ns)
    return {"auc": attack_auc(ms, ns), "advantage": adv, "threshold": thr,
            "member_mean": float(ms.mean()),
            "nonmember_mean": float(ns.mean())}
