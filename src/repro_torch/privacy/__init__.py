"""Privacy subsystem (port of ``repro/privacy``): the defenses and the
leakage metrics.

defenses.py  — DP-SGD (per-example clip + noise via kernels/dp_clip), a
               pre-codec uplink DP stage, and an RDP accountant;
metrics.py   — PSNR / SSIM, the boundary distance correlation the split
               controller probes, and the membership AUC / advantage.

The attacks wait for ROADMAP Queue A item 9.
"""
from repro_torch.privacy.defenses import (DPUplinkStage, RDPAccountant,
                                          dp_epsilon, make_dp_d_step,
                                          make_uplink_stage,
                                          min_feasible_sigma,
                                          rdp_sampled_gaussian,
                                          sigma_for_epsilon)
from repro_torch.privacy.metrics import (attack_advantage, attack_auc,
                                         best_match_psnr,
                                         distance_correlation, psnr, ssim)

__all__ = ["DPUplinkStage", "RDPAccountant", "attack_advantage",
           "attack_auc", "best_match_psnr", "distance_correlation",
           "dp_epsilon", "make_dp_d_step", "make_uplink_stage",
           "min_feasible_sigma", "psnr", "rdp_sampled_gaussian",
           "sigma_for_epsilon", "ssim"]
