"""Tunable defenses for the artifacts that leave the device.  Port of
``repro/privacy/defenses.py``.

  * **DP-SGD** (Abadi et al. 2016) on the device-side discriminator update:
    per-example L2 clipping + Gaussian noise, through the ``kernels/dp_clip``
    CUDA kernel (or its plain version).  The per-example gradient is taken
    on singleton batches, so batch-norm statistics are per-example.
  * **Uplink DP** — clip-and-noise the whole update delta once per round,
    *before* the transport codec compresses it (a pre-codec stage for
    ``fed/engine.FederationEngine``).
  * **RDP accountant** for the (subsampled) Gaussian mechanism (Mironov
    2017; Mironov et al. 2019), copied from the reference: pure Python
    math, so epsilon equals the reference's to the last bit.

Noise comes from :mod:`repro_torch.keys`: a draw is a function of
(seed, client index, round) for the uplink stage, not of JAX's streams.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import keys
from repro_torch.optim.optimizers import global_norm
from repro_torch.tree import leaves, unflatten_like

# ---------------------------------------------------------------------------
# RDP accountant — subsampled Gaussian mechanism
# ---------------------------------------------------------------------------

INTEGER_ORDERS: Tuple[float, ...] = tuple(range(2, 33)) + (40, 48, 56, 64,
                                                           128)
# dense fractional grid interleaving the integer orders: the optimal
# Rényi order for a given (sigma, q, steps, delta) is rarely an integer,
# so the integer-only grid systematically over-reports epsilon.  Kept
# below 64 — the fractional series converges slowly at very high orders
# and the tail integers cover that regime.
FRACTIONAL_ORDERS: Tuple[float, ...] = tuple(
    round(1.25 + 0.25 * i, 2) for i in range(4 * 31)
    if (1.25 + 0.25 * i) != int(1.25 + 0.25 * i)) + tuple(
    round(x + 0.5, 1) for x in range(32, 64))
DEFAULT_ORDERS: Tuple[float, ...] = tuple(sorted(
    set(INTEGER_ORDERS) | set(FRACTIONAL_ORDERS)))


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def _logsumexp(xs) -> float:
    m = max(xs)
    if m == float("-inf"):
        return m
    return m + math.log(sum(math.exp(x - m) for x in xs))


def _log_add(logx: float, logy: float) -> float:
    """log(exp(logx) + exp(logy)), stable."""
    a, b = max(logx, logy), min(logx, logy)
    if b == float("-inf"):
        return a
    return a + math.log1p(math.exp(b - a))


def _log_sub(logx: float, logy: float) -> float:
    """log(exp(logx) - exp(logy)); requires logx >= logy."""
    if logy == float("-inf"):
        return logx
    if logx < logy:
        raise ValueError("log_sub of a larger value")
    if logx == logy:
        return float("-inf")
    return logx + math.log1p(-math.exp(logy - logx))


def _log_erfc(x: float) -> float:
    """log(erfc(x)), with the asymptotic expansion once erfc underflows."""
    r = math.erfc(x)
    if r > 1e-300:
        return math.log(r)
    return (-math.log(math.pi) / 2 - math.log(x) - x * x
            - 0.5 / (x * x) + 0.625 / x ** 4
            - 37.0 / 24.0 / x ** 6 + 353.0 / 64.0 / x ** 8)


def _rdp_frac(q: float, sigma: float, alpha: float) -> float:
    """Sampled-Gaussian RDP at fractional order (Mironov et al. 2019,
    §3.3): the binomial series over real alpha, each term weighted by
    Gaussian tail masses (log-erfc), accumulated in log space until the
    terms vanish.  Matches the integer closed form at integer alpha."""
    log_a0, log_a1 = float("-inf"), float("-inf")
    i, z0 = 0, sigma ** 2 * math.log(1.0 / q - 1.0) + 0.5
    coef_log, coef_sign = 0.0, 1.0            # log|binom(alpha, i)|, sign
    while True:
        j = alpha - i
        log_t0 = coef_log + i * math.log(q) + j * math.log1p(-q)
        log_t1 = coef_log + j * math.log(q) + i * math.log1p(-q)
        log_e0 = math.log(0.5) + _log_erfc((i - z0) / (math.sqrt(2) * sigma))
        log_e1 = math.log(0.5) + _log_erfc((z0 - j) / (math.sqrt(2) * sigma))
        log_s0 = log_t0 + (i * i - i) / (2.0 * sigma ** 2) + log_e0
        log_s1 = log_t1 + (j * j - j) / (2.0 * sigma ** 2) + log_e1
        if coef_sign > 0:
            log_a0 = _log_add(log_a0, log_s0)
            log_a1 = _log_add(log_a1, log_s1)
        else:
            log_a0 = _log_sub(log_a0, log_s0)
            log_a1 = _log_sub(log_a1, log_s1)
        i += 1
        # next binomial coefficient: binom(a, i) = binom(a, i-1)*(a-i+1)/i
        factor = (alpha - i + 1.0) / i
        if factor == 0.0:
            break
        coef_log += math.log(abs(factor))
        if factor < 0.0:
            coef_sign = -coef_sign
        if max(log_s0, log_s1) < -30.0 and i > alpha:
            break
    return _log_add(log_a0, log_a1) / (alpha - 1.0)


def rdp_sampled_gaussian(q: float, noise_multiplier: float,
                         order: float) -> float:
    """RDP of one step of the sampled Gaussian mechanism at any real
    order > 1 (integer or fractional).

    q: sampling probability; noise_multiplier: sigma (noise stddev / clip).
    q = 1 is the plain Gaussian mechanism: alpha / (2 sigma^2) for any real
    alpha.  For q < 1, integer orders use the exact binomial expression
    (Mironov et al. 2019, eq. 3):

        RDP(a) = log( sum_k C(a,k) (1-q)^(a-k) q^k exp((k^2-k)/(2 s^2)) )
                 / (a - 1)

    and fractional orders the real-alpha series (:func:`_rdp_frac`).
    """
    if q == 0.0 or noise_multiplier == float("inf"):
        return 0.0
    if noise_multiplier <= 0.0:
        return float("inf")
    if not 0.0 < q <= 1.0:
        raise ValueError(f"sampling rate {q} outside (0, 1]")
    if order <= 1:
        raise ValueError(f"order > 1 required, got {order}")
    s2 = float(noise_multiplier) ** 2
    if q == 1.0:
        return order / (2.0 * s2)
    if int(order) != order:
        return _rdp_frac(q, float(noise_multiplier), float(order))
    order = int(order)
    terms = [_log_comb(order, k) + k * math.log(q)
             + (order - k) * math.log1p(-q) + (k * k - k) / (2.0 * s2)
             for k in range(order + 1)]
    return _logsumexp(terms) / (order - 1)


class RDPAccountant:
    """Tracks cumulative RDP over steps; converts to (epsilon, delta).

    One ``step()`` = one application of the mechanism (one DP-SGD batch, or
    one noised uplink round).  RDP composes additively across steps — and
    because it does, the mechanism's noise multiplier may CHANGE between
    steps (``step(n, noise_multiplier=...)``): each batch of steps
    contributes its own per-order RDP to the running total.  This is what
    lets the control plane's sigma controller retune sigma per round while
    the accountant stays exact (per-sigma RDP vectors are cached).
    """

    def __init__(self, noise_multiplier: float, sample_rate: float = 1.0,
                 orders: Tuple[int, ...] = DEFAULT_ORDERS):
        self.noise_multiplier = float(noise_multiplier)
        self.sample_rate = float(sample_rate)
        self.orders = tuple(orders)
        self._rdp_cache: Dict[float, List[float]] = {}
        # warm the default-sigma cache now: a bad (q, sigma) pair raises at
        # construction, not on the first step() mid-training
        self._rdp_for(self.noise_multiplier)
        self._rdp_total = [0.0] * len(self.orders)
        self.steps = 0

    def _rdp_for(self, sigma: float) -> List[float]:
        sigma = float(sigma)
        if sigma not in self._rdp_cache:
            self._rdp_cache[sigma] = [
                rdp_sampled_gaussian(self.sample_rate, sigma, a)
                for a in self.orders]
        return self._rdp_cache[sigma]

    def step(self, num_steps: int = 1,
             noise_multiplier: Optional[float] = None) -> None:
        """Record ``num_steps`` mechanism applications at
        ``noise_multiplier`` (default: the constructor's sigma)."""
        n = int(num_steps)
        if n <= 0:
            # nothing released — and with sigma <= 0 the per-step RDP is
            # inf, where 0 * inf would NaN-poison the running totals
            return
        sigma = (self.noise_multiplier if noise_multiplier is None
                 else float(noise_multiplier))
        r = self._rdp_for(sigma)
        self._rdp_total = [t + n * x for t, x in zip(self._rdp_total, r)]
        self.steps += n

    def epsilon(self, delta: float = 1e-5) -> Tuple[float, int]:
        """Best (epsilon, order) over the tracked orders.

        Classic conversion (Mironov 2017 Prop. 3):
        eps = RDP(a) - log(delta) / (a - 1).
        """
        if self.steps == 0:
            return 0.0, self.orders[0]
        best_eps, best_order = float("inf"), self.orders[0]
        for a, t in zip(self.orders, self._rdp_total):
            eps = t - math.log(delta) / (a - 1)
            if eps < best_eps:
                best_eps, best_order = eps, a
        return best_eps, best_order

    def projected_epsilon(self, extra_steps: int, delta: float = 1e-5,
                          noise_multiplier: Optional[float] = None) -> float:
        """Epsilon this accountant WOULD report after ``extra_steps`` more
        applications at ``noise_multiplier`` — the sigma controller's
        budget-feasibility oracle (nothing is committed)."""
        n = int(extra_steps)
        if self.steps + n == 0:
            return 0.0
        sigma = (self.noise_multiplier if noise_multiplier is None
                 else float(noise_multiplier))
        r = self._rdp_for(sigma)
        # n == 0 must not multiply a (possibly inf) per-step RDP
        return min(t + (n * x if n else 0.0) - math.log(delta) / (a - 1)
                   for a, t, x in zip(self.orders, self._rdp_total, r))


def dp_epsilon(noise_multiplier: float, sample_rate: float, steps: int,
               delta: float = 1e-5) -> float:
    """One-shot epsilon for a finished run (benchmarks/examples)."""
    acct = RDPAccountant(noise_multiplier, sample_rate)
    acct.step(steps)
    return acct.epsilon(delta)[0]


def min_feasible_sigma(feasible, lo: float, hi: float,
                       rel_tol: float = 1e-4) -> float:
    """Smallest sigma in ``[lo, hi]`` satisfying ``feasible(sigma)``, by
    geometric bisection — THE inversion primitive for every RDP epsilon
    curve (``feasible`` must be monotone in sigma: more noise never hurts,
    property-tested via :func:`sigma_for_epsilon`).

    Always returns the bracket's FEASIBLE endpoint, never the midpoint —
    the detail the sigma controller's never-exceed guarantee rests on.
    Returns ``hi`` when even maximum noise is infeasible (the caller's
    clamp-to-most-protection boundary)."""
    lo, hi = float(lo), float(hi)
    if feasible(lo):
        return lo
    if not feasible(hi):
        return hi
    while hi / lo > 1.0 + rel_tol:
        mid = math.sqrt(lo * hi)
        if feasible(mid):
            hi = mid
        else:
            lo = mid
    return hi


def sigma_for_epsilon(epsilon: float, steps: int, delta: float = 1e-5,
                      sample_rate: float = 1.0, lo: float = 1e-3,
                      hi: float = 1e4, rel_tol: float = 1e-4) -> float:
    """Invert the RDP epsilon curve: the smallest noise multiplier whose
    fresh run of ``steps`` sampled-Gaussian applications spends at most
    ``(epsilon, delta)``.

    Epsilon is strictly decreasing in sigma on the fractional-order grid
    (property-tested), so :func:`min_feasible_sigma` converges and the
    returned sigma always satisfies ``dp_epsilon(sigma, ...) <= epsilon``.
    """
    if epsilon <= 0.0:
        raise ValueError(f"epsilon budget must be positive, got {epsilon}")
    if steps <= 0:
        return float(lo)
    return min_feasible_sigma(
        lambda s: dp_epsilon(s, sample_rate, int(steps), delta) <= epsilon,
        lo, hi, rel_tol)


# ---------------------------------------------------------------------------
# DP-SGD device-side discriminator step
# ---------------------------------------------------------------------------

def make_dp_d_step(optimizer, loss_fn, lr: float, clip_norm: float,
                   noise_multiplier: float, *, use_kernel: bool = False):
    """The DP-SGD discriminator step: per-example gradients on singleton
    batches, per-example L2 clip to ``clip_norm``, Gaussian noise of stddev
    ``noise_multiplier * clip_norm`` on the SUM (``kernels/dp_clip``), the
    mean to the optimizer.

    A thin lr-baking wrapper over ``fed/programs.make_local_step``: the DP
    step definition exists once, so the sequential reference and the
    engine's loop can never drift apart.

    Returns ``dp_step(params, opt, real, fake, key) -> (params, opt,
    loss)``; ``key`` is the step's noise key (:mod:`repro_torch.keys`).
    """
    from repro_torch.config import PrivacyConfig
    from repro_torch.fed.programs import make_local_step

    step = make_local_step(
        optimizer, loss_fn,
        PrivacyConfig(enabled=True, mode="dp_sgd", clip_norm=clip_norm,
                      noise_multiplier=noise_multiplier,
                      use_kernel=use_kernel))

    def dp_step(params, opt, real, fake, key):
        return step(params, opt, real, fake, lr, key)

    return dp_step


# ---------------------------------------------------------------------------
# uplink delta clip-and-noise — a pre-codec transport stage
# ---------------------------------------------------------------------------

class DPUplinkStage:
    """Clip + noise the uplink delta once per round, before the codec.

    The engine calls ``stage(client_id, delta_tree)`` between delta
    computation and codec round-trip (fed/engine.py).  The delta's GLOBAL
    L2 norm is clipped to ``clip_norm`` and elementwise Gaussian noise of
    stddev ``noise_multiplier * clip_norm`` is added.  The noise is a
    function of (seed, client index, round): clients are indexed by first
    appearance (collision-free, unlike a hash of the id), and one
    generator draws every leaf in ``leaves`` order on the delta's device.
    """

    def __init__(self, clip_norm: float, noise_multiplier: float,
                 seed: int = 0):
        self.clip_norm = float(clip_norm)
        self.noise_multiplier = float(noise_multiplier)
        self.seed = int(seed)
        self._round: Dict[str, int] = {}
        self._index: Dict[str, int] = {}

    def _key(self, cid: str) -> keys.Key:
        if cid not in self._index:
            self._index[cid] = len(self._index)
        i = self._round.get(cid, 0)
        self._round[cid] = i + 1
        return keys.fold_in(keys.root(keys.UPLINK, self.seed),
                            self._index[cid], i)

    def __call__(self, cid: str, delta):
        ls = leaves(delta)
        norm = global_norm(delta)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        sigma = self.noise_multiplier * self.clip_norm
        gen = keys.generator(self._key(cid), ls[0].device)
        out = [(l.to(torch.float32) * scale
                + sigma * torch.randn(l.shape, generator=gen,
                                      device=l.device, dtype=torch.float32)
                ).to(l.dtype) for l in ls]
        return unflatten_like(delta, out)


def make_uplink_stage(priv_cfg) -> Optional[DPUplinkStage]:
    """cfg.privacy -> pre-codec stage, or None when not in uplink mode."""
    if priv_cfg is None or not priv_cfg.enabled or priv_cfg.mode != "uplink":
        return None
    return DPUplinkStage(priv_cfg.clip_norm, priv_cfg.noise_multiplier,
                         priv_cfg.seed)
