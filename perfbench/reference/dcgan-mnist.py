"""Plain PyTorch reference of the FSL-GAN round on dcgan-mnist.

The paper's round (arXiv:2207.01750, the FSL-GAN of Radford et al.'s
DCGAN, arXiv:1511.06434), written out from its definition and imported
from nothing of the program:

1. Each client trains its discriminator for ``batches_per_client`` steps
   on its real images and the server's fakes, G(z), with the
   non-saturating BCE loss and Adam.  Under DP-SGD each example's
   gradient is clipped to ``privacy.clip_norm`` and Gaussian noise of
   ``noise_multiplier x clip_norm`` is added to their sum.  With the
   executed split, the discriminator runs as device segments (the
   ``sorted_multi`` plan of the paper's device pool) and every tensor
   that crosses a segment boundary, each example's activation forward and
   its gradient back, passes int8 quantisation (one scale an example),
   a clip to ``stage_clip`` and noise of ``stage_sigma x stage_clip``.
2. The server averages the discriminators, weighted by examples; an int8
   uplink sends each client's update delta quantised a leaf at a time.
3. G takes ``batches_per_client`` Adam steps against the averaged D.

Convolutions follow XLA's ``SAME`` padding (asymmetric at stride 2) and
the unflipped transposed convolution; batch norm uses each batch's
statistics (a lone example's under DP-SGD).  The data order and the noise
keys are the port's documented contract: the host stream
``np.random.default_rng(trainer seed)`` draws each client's batches in
roster order (image indices, then z) and then G's z; noise key paths as
in ``perfbench.common``.

``lowp=True`` computes every convolution and matrix product with TF32
operands (10 mantissa bits), the control that must fail.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.common import KEY_DP_SGD, KEY_STAGE, key_normal, leaf_norms

ARCHETYPES = [(0.4, 2), (1.0, 2), (2.5, 4), (0.6, 1)]   # (time, capacity)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (Veltkamp's split: the
    high part of ``x`` at 24 - 13 significant bits); the gradient passes
    straight through."""
    xd = x.detach()
    c = xd * 8193.0
    r = c - (c - xd)
    return x + (r - x).detach()


class Ops:
    def __init__(self, lowp: bool):
        self.q = tf32 if lowp else (lambda t: t)

    def conv(self, x, w_hwio, stride, pads):
        """NCHW convolution, ``pads`` = (h_lo, h_hi, w_lo, w_hi)."""
        x = F.pad(x, (pads[2], pads[3], pads[0], pads[1]))
        return F.conv2d(self.q(x), self.q(w_hwio.permute(3, 2, 0, 1)),
                        stride=stride)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


def same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def batch_norm(p, x):
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    y = (x - mu) / torch.sqrt(var + 1e-5)
    return y * p["scale"].view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)


def d_layer(ops: Ops, name: str, p, x):
    """One discriminator layer on an NHWC batch."""
    if name == "classifier":
        return ops.mm(x.reshape(x.shape[0], -1), p[name]["w"]) + p[name]["b"]
    lp = p[name]
    xc = x.permute(0, 3, 1, 2)
    ph = same_pads(xc.shape[2], 5, 2)
    pw = same_pads(xc.shape[3], 5, 2)
    y = ops.conv(xc, lp["w"], 2, ph + pw) + lp["b"].view(1, -1, 1, 1)
    if "bn" in lp:
        y = batch_norm(lp["bn"], y)
    return F.leaky_relu(y, 0.2).permute(0, 2, 3, 1)


def d_names(m) -> List[str]:
    return [f"conv{i}" for i in range(m["conv_blocks"])] + ["classifier"]


def d_apply(ops, m, p, x):
    for n in d_names(m):
        x = d_layer(ops, n, p, x)
    return x


def deconv(ops, x, lp):
    """Stride-2 'SAME' transposed convolution: zeros inserted between the
    input pixels, padded (3, 2), then a plain (unflipped) convolution."""
    b, c, h, w = x.shape
    z = x.new_zeros((b, c, 2 * h - 1, 2 * w - 1))
    z[:, :, ::2, ::2] = x
    return ops.conv(z, lp["w"], 1, (3, 2, 3, 2)) + lp["b"].view(1, -1, 1, 1)


def g_apply(ops, m, p, z):
    f, s0 = m["base_filters"], m["image_size"] // 4
    x = ops.mm(z, p["proj"]["w"]) + p["proj"]["b"]
    x = x.reshape(z.shape[0], s0, s0, 4 * f).permute(0, 3, 1, 2)
    x = torch.relu(batch_norm(p["proj"]["bn"], x))
    x = torch.relu(batch_norm(p["deconv0"]["bn"], deconv(ops, x, p["deconv0"])))
    x = torch.relu(batch_norm(p["deconv1"]["bn"], deconv(ops, x, p["deconv1"])))
    x = ops.conv(x, p["out"]["w"], 1, (2, 2, 2, 2)) \
        + p["out"]["b"].view(1, -1, 1, 1)
    return torch.tanh(x).permute(0, 2, 3, 1)


def bce(logits, target: float):
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


# ---------------------------------------------------------------------------
# the paper's device pool and the sorted_multi split plan
# ---------------------------------------------------------------------------

def client_segments(m, fsl) -> List[List[List[str]]]:
    """Each client's discriminator segments: devices sorted by capacity
    over time factor, each filled to its capacity in layer order."""
    if fsl["heterogeneity"] != "paper" or fsl["selection"] != "sorted_multi":
        raise ValueError("the reference plans the paper pool, sorted_multi")
    rng = np.random.default_rng(fsl["seed"])
    names = d_names(m)
    out = []
    for _ in range(fsl["num_clients"]):
        order = rng.permutation(len(ARCHETYPES))
        devs = []
        for i in range(fsl["devices_per_client"]):
            t, cap = ARCHETYPES[order[i % len(ARCHETYPES)]]
            devs.append((t * float(rng.uniform(0.8, 1.25)), cap))
        devs.sort(key=lambda d: -(d[1] / max(d[0], 1e-9)))
        segs, li = [], 0
        for _, cap in devs:
            if li >= len(names):
                break
            take = min(cap, len(names) - li)
            segs.append(names[li:li + take])
            li += take
        out.append(segs)
    return out


# ---------------------------------------------------------------------------
# the D step, plain and DP-SGD (optionally through the split)
# ---------------------------------------------------------------------------

def int8_rows(x):
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def int8_tensor(x):
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def stage(x, key, clip, sigma):
    """The boundary crossing of a (B, ...) tensor of examples."""
    flat = x.reshape(x.shape[0], -1)
    q = int8_rows(flat)
    norm = torch.sqrt((q * q).sum(dim=1, keepdim=True))
    y = q * torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    y = y + sigma * clip * key_normal(key, y.shape, y.device)
    return y.reshape(x.shape)


def per_example_grads(ops, m, p, real, fake, segs, key, split):
    """Each example's loss and gradient, BCE(real, 1) + BCE(fake, 0) on
    that example alone; through the split's segments and crossings when
    ``split`` is given, else monolithic."""
    vmap = torch.func.vmap
    if not split:
        segs = [d_names(m)]

    def seg_fn(names):
        def f(q, xr, xf):
            outs = []
            for x in (xr, xf):
                y = x[None]
                for n in names:
                    y = d_layer(ops, n, q, y)
                outs.append(y[0])
            return tuple(outs)
        return f

    subs = [{n: p[n] for n in s} for s in segs]
    last = len(segs) - 1
    xs, seg_in = (real, fake), []

    def cross(si, pass_, direction, x):
        k = key + (1 + (si * 2 + pass_) * 2 + direction,)
        return stage(x, k, split["stage_clip"], split["stage_sigma"])

    with torch.no_grad():
        for si in range(last):
            seg_in.append(xs)
            outs = vmap(seg_fn(segs[si]), in_dims=(None, 0, 0))(subs[si], *xs)
            xs = tuple(cross(si, i, 0, o) for i, o in enumerate(outs))
    tail = seg_fn(segs[last])

    def loss_one(q, xr, xf):
        zr, zf = tail(q, xr, xf)
        return bce(zr[None], 1.0) + bce(zf[None], 0.0)

    grads: Dict[str, Any] = {}
    gfn = torch.func.grad_and_value(loss_one, argnums=(0, 1, 2))
    (g_last, *g_act), losses = vmap(gfn, in_dims=(None, 0, 0))(subs[last], *xs)
    grads.update(g_last)
    for si in range(last - 1, -1, -1):
        with torch.no_grad():
            g_act = [cross(si, i, 1, g) for i, g in enumerate(g_act)]
        f = seg_fn(segs[si])

        def vjp_one(q, xr, xf, gr, gf, f=f):
            _, back = torch.func.vjp(f, q, xr, xf)
            return back((gr, gf))
        gq, gr, gf = vmap(vjp_one, in_dims=(None, 0, 0, 0, 0))(
            subs[si], *seg_in[si], *g_act)
        grads.update(gq)
        g_act = [gr, gf]
    return losses, grads


def flat_leaves(tree, lead: int):
    from perfbench.common import named_leaves
    return torch.cat([t.reshape(*t.shape[:lead], -1)
                      for _, t in named_leaves(tree)], dim=-1)


def unflat(vec, like):
    from perfbench.common import named_leaves
    out, off = {}, 0
    for name, t in named_leaves(like):
        n = t.numel()
        cur = out
        parts = name.split("/")
        for k in parts[:-1]:
            cur = cur.setdefault(k, {})
        cur[parts[-1]] = vec[off:off + n].reshape(t.shape)
        off += n
    return out


def tmap(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Adam:
    def __init__(self, params, o):
        self.o = o
        self.m = tmap(torch.zeros_like, params)
        self.v = tmap(torch.zeros_like, params)
        self.t = 0

    def step(self, params, grads):
        o = self.o
        self.t += 1
        b1, b2 = o["beta1"], o["beta2"]
        self.m = tmap(lambda m, g: b1 * m + (1 - b1) * g, self.m, grads)
        self.v = tmap(lambda v, g: b2 * v + (1 - b2) * g * g, self.v, grads)
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        return tmap(lambda p, m, v: p - o["lr"] * (m / c1) / (
            torch.sqrt(v / c2) + o["eps"]), params, self.m, self.v)


def run(config: Dict[str, Any], traffic: Dict[str, Any],
        path: Dict[str, Any], p0: Dict[str, Any],
        data: Dict[str, np.ndarray], trainer_seed: int, *, steps: int,
        device, lowp: bool = False, other_state1=None,
        keep: bool = False) -> Dict[str, Any]:
    """The reference's record of the first ``steps`` rounds: each round's
    mean D loss and mean G loss, each client's first D step's loss, each
    leaf's Adam first moment after the first round (G, and each client's
    D), the gradient basis of the quiet rule, and each leaf's change after
    the last round.  Given ``other_state1`` (another run's G and averaged
    D after the first round, leaf by leaf on the host), each leaf's norm of
    the difference to this one's (``diff1``) and of this one's change in
    the round (``change1``); ``keep`` keeps this one's on the host
    (``kept``)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run(config, traffic, path, p0, data, trainer_seed, steps,
                    torch.device(device), Ops(lowp), other_state1, keep)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _run(config, traffic, path, p0, data, trainer_seed, steps, dev, ops,
         other, keep):
    m, fsl, o = config["model"], config["fsl"], config["optim"]
    bsz, batches = config["batch"], int(traffic["batches_per_client"])
    clients = [f"c{i}" for i in range(fsl["num_clients"])]
    dp = path.get("privacy.enabled", False) \
        and path.get("privacy.mode", "dp_sgd") == "dp_sgd"
    split = None
    if path.get("split.enabled", False):
        if path.get("split.boundary_stage") != "int8+dp":
            raise ValueError("the reference's split stage is int8+dp")
        split = {"stage_clip": float(path["split.stage_clip"]),
                 "stage_sigma": float(path["split.stage_sigma"])}
    codec = path.get("fed.codec", "none")
    if codec not in ("none", "int8"):
        raise ValueError("the reference's uplink codecs: none, int8")
    segs = client_segments(m, fsl)
    rng = np.random.default_rng(trainer_seed)
    weights = [float(len(data[c])) if fsl.get("weighted_average", True)
               else 1.0 for c in clients]
    wsum = sum(weights)

    g = tmap(lambda t: t.to(dev, torch.float32).clone(), p0["G"])
    d_global = tmap(lambda t: t.to(dev, torch.float32).clone(), p0["D"])
    g_opt = Adam(g, o)
    d_opts = [Adam(d_global, o) for _ in clients]
    rec: Dict[str, Any] = {"losses": []}
    for r in range(steps):
        round_key = (KEY_DP_SGD, path["privacy.seed"], r) if dp else \
            (KEY_STAGE, path["split.seed"], r)
        d_losses, new = [], []
        for i, cid in enumerate(clients):
            d = d_global
            for t in range(batches):
                idx = rng.integers(0, len(data[cid]), bsz)
                real = torch.from_numpy(data[cid][idx]).to(dev)
                z = torch.from_numpy(rng.standard_normal(
                    (bsz, m["latent_dim"]), dtype=np.float32)).to(dev)
                with torch.no_grad():
                    fake = g_apply(ops, m, g, z)
                key = round_key + (0, i, 0, t)
                if dp:
                    losses, per = per_example_grads(
                        ops, m, d, real, fake, segs[i], key, split)
                    flat = flat_leaves(per, 1)
                    norm = torch.sqrt((flat * flat).sum(dim=1, keepdim=True))
                    clip = float(path["privacy.clip_norm"])
                    summed = (flat * torch.clamp(
                        clip / torch.clamp(norm, min=1e-12), max=1.0)).sum(0)
                    summed = summed + float(path["privacy.noise_multiplier"]) \
                        * clip * key_normal(key, summed.shape, dev)
                    grads = unflat(summed / bsz, d)
                    loss = losses.mean()
                    del per, flat
                else:
                    if split:
                        raise ValueError("split without DP-SGD is not a cell")
                    live = tmap(lambda t: t.detach().requires_grad_(True), d)
                    with torch.enable_grad():
                        loss = bce(d_apply(ops, m, live, real), 1.0) \
                            + bce(d_apply(ops, m, live, fake), 0.0)
                        flat = [t for _, t in _named(live)]
                        got = torch.autograd.grad(loss, flat)
                    grads = unflat(torch.cat([x.reshape(-1) for x in got]), d)
                d = d_opts[i].step(d, grads)
                d_losses.append(float(loss.detach()))
                if r == 0 and t == 0:
                    rec.setdefault("first_losses", []).append(d_losses[-1])
            new.append(d)
        acc = None
        for w, d in zip(weights, new):
            if codec == "int8":
                part = tmap(lambda a, b: w * int8_tensor(a - b), d, d_global)
            else:
                part = tmap(lambda a: w * a, d)
            acc = part if acc is None else tmap(torch.add, acc, part)
        if codec == "int8":
            d_global = tmap(lambda b, a: b + a / wsum, d_global, acc)
        else:
            d_global = tmap(lambda a: a / wsum, acc)
        g_losses = []
        for t in range(batches):
            z = torch.from_numpy(rng.standard_normal(
                (bsz, m["latent_dim"]), dtype=np.float32)).to(dev)
            live = tmap(lambda x: x.detach().requires_grad_(True), g)
            with torch.enable_grad():
                loss = bce(d_apply(ops, m, d_global, g_apply(ops, m, live, z)),
                           1.0)
                got = torch.autograd.grad(loss, [x for _, x in _named(live)])
            g = g_opt.step(g, unflat(torch.cat([x.reshape(-1) for x in got]),
                                     g))
            g_losses.append(float(loss.detach()))
        rec["losses"] += [float(np.mean(d_losses)), float(np.mean(g_losses))]
        if r == 0:
            rec["grad1"] = leaf_norms(g_opt.m, "G")
            basis = {f"G/{k}": v for k, v in leaf_norms(g_opt.m).items()}
            dmax: Dict[str, float] = {}
            for i, opt in enumerate(d_opts):
                norms = leaf_norms(opt.m)
                rec["grad1"].update({f"D{i}/{k}": v for k, v in norms.items()})
                for k, v in norms.items():
                    dmax[f"D/{k}"] = max(dmax.get(f"D/{k}", 0.0), v)
            rec["grad_basis"] = {**basis, **dmax}
            state1 = {**{f"G/{k}": t for k, t in _named(g)},
                      **{f"D/{k}": t for k, t in _named(d_global)}}
            start = {**{f"G/{k}": t for k, t in _named(p0["G"])},
                     **{f"D/{k}": t for k, t in _named(p0["D"])}}
            if other is not None:
                rec["diff1"] = {n: float(torch.linalg.vector_norm(
                    other[n].to(dev) - t)) for n, t in state1.items()}
                rec["change1"] = {n: float(torch.linalg.vector_norm(
                    t - start[n].to(dev))) for n, t in state1.items()}
            if keep:
                rec["kept"] = {n: t.cpu() for n, t in state1.items()}
    rec["change3"] = {
        **leaf_norms(tmap(lambda a, b: a - b.to(dev), g, p0["G"]), "G"),
        **leaf_norms(tmap(lambda a, b: a - b.to(dev), d_global, p0["D"]),
                     "D")}
    return rec


def _named(tree):
    from perfbench.common import named_leaves
    return named_leaves(tree)
