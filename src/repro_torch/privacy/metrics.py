"""Leakage metrics: how much did an attack actually recover?  Port of
``repro/privacy/metrics.py``.

Three families, matching the three attack surfaces:

  * **reconstruction quality** — PSNR and SSIM between recovered and true
    images (gradient/activation inversion).  ``best_match_psnr`` handles
    the permutation ambiguity of batch-level gradient inversion (the
    attacker recovers the batch as a set, not in order).
  * **dependence leakage** — distance correlation (Székely et al. 2007)
    between raw inputs and the smashed activations crossing a split
    boundary: 0 = independent, 1 = deterministic dependence.  This is the
    per-split-depth leakage curve of *Evaluating Privacy Leakage in Split
    Learning*: deeper cuts leak less.  The split controller's dCor probe
    reads it (``core/gan.FSLGANTrainer._probe_boundary_dcor``).
  * **membership exposure** — attack AUC (rank statistic, threshold-free)
    and membership advantage max_t (TPR(t) - FPR(t)) (Yeom et al. 2018).

Images and activations are tensors (or arrays) on any device, and each
metric is computed on the input's device: PSNR and SSIM in float32, as the
reference computes them; the distance correlation in float64.  In float32
the distance matrix's diagonal (``|x|^2 + |x|^2 - 2 x.x``) keeps a
cancellation residue that depends on each framework's summation order,
which moves a dCor near 1 by up to ~2e-6 (either framework's, against the
float64 value); in float64 the port gives the formula's value.  The
membership statistics run in float64 numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64).reshape(-1)


# ---------------------------------------------------------------------------
# reconstruction quality
# ---------------------------------------------------------------------------

def psnr(a, b, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio in dB; images in [-1, 1] => range 2."""
    mse = float(torch.mean((_f32(a) - _f32(b)) ** 2))
    if mse <= 0.0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean filter over HxW of (B, H, W, C), VALID windows."""
    c = x.shape[-1]
    k = torch.full((c, 1, win, win), 1.0 / float(win * win),
                   dtype=torch.float32, device=x.device)
    out = F.conv2d(x.permute(0, 3, 1, 2), k, groups=c)
    return out.permute(0, 2, 3, 1)


def ssim(a, b, data_range: float = 2.0, win: int = 7) -> float:
    """Mean structural similarity (Wang et al. 2004), uniform window."""
    a, b = _f32(a), _f32(b)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = _uniform_filter(a, win), _uniform_filter(b, win)
    var_a = _uniform_filter(a * a, win) - mu_a * mu_a
    var_b = _uniform_filter(b * b, win) - mu_b * mu_b
    cov = _uniform_filter(a * b, win) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return float(torch.mean(num / den))


def best_match_psnr(recon, target, data_range: float = 2.0) -> float:
    """Mean over reconstructions of the best PSNR against any target image
    (gradient inversion recovers the batch up to permutation)."""
    scores = []
    for i in range(recon.shape[0]):
        scores.append(max(psnr(recon[i], target[j], data_range)
                          for j in range(target.shape[0])))
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# dependence leakage at split boundaries
# ---------------------------------------------------------------------------

def _centered_dist(x: torch.Tensor) -> torch.Tensor:
    """Double-centered pairwise Euclidean distance matrix of (B, D)."""
    sq = torch.sum(x * x, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0)
    d = torch.sqrt(d2 + 1e-12)
    return (d - torch.mean(d, dim=0, keepdim=True)
            - torch.mean(d, dim=1, keepdim=True) + torch.mean(d))


def distance_correlation(x, y) -> float:
    """Sample distance correlation between two batches (leading axis B).

    Leaves are flattened per example; dCor in [0, 1] measures how much the
    smashed activation y still determines the raw input x.
    """
    x = _f32(x).to(torch.float64)
    y = _f32(y).to(torch.float64)
    b = x.shape[0]
    xa = _centered_dist(x.reshape(b, -1))
    yb = _centered_dist(y.reshape(b, -1))
    dcov2 = torch.mean(xa * yb)
    dvar_x = torch.mean(xa * xa)
    dvar_y = torch.mean(yb * yb)
    den = torch.sqrt(dvar_x * dvar_y)
    if not float(den) > 0:
        return 0.0
    return float(torch.sqrt(torch.clamp(dcov2, min=0.0)
                            / torch.clamp(den, min=1e-12)))


# ---------------------------------------------------------------------------
# membership exposure
# ---------------------------------------------------------------------------

def attack_auc(member_scores, nonmember_scores) -> float:
    """Rank AUC: P(member score > non-member score) + 0.5 P(tie)."""
    m, n = _np64(member_scores), _np64(nonmember_scores)
    gt = (m[:, None] > n[None, :]).sum()
    eq = (m[:, None] == n[None, :]).sum()
    return float((gt + 0.5 * eq) / (len(m) * len(n)))


def attack_advantage(member_scores, nonmember_scores) -> Tuple[float, float]:
    """(advantage, threshold): max_t TPR(t) - FPR(t) over all score cuts."""
    m, n = _np64(member_scores), _np64(nonmember_scores)
    best, best_t = 0.0, float("-inf")
    for t in np.unique(np.concatenate([m, n])):
        adv = float((m >= t).mean() - (n >= t).mean())
        if adv > best:
            best, best_t = adv, float(t)
    return best, best_t
