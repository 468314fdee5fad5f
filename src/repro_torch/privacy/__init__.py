"""Privacy subsystem (port of ``repro/privacy``): measure what the fed
runtime leaks, and defend it.

attacks.py   — gradient inversion, activation inversion (of the clean
               prefix and of the tensors an executed split ships),
               membership inference against the artifacts that cross the
               wire;
defenses.py  — DP-SGD (per-example clip + noise via kernels/dp_clip), a
               pre-codec uplink DP stage, and an RDP accountant;
metrics.py   — PSNR / SSIM, the boundary distance correlation the split
               controller probes, and the membership AUC / advantage.
"""
from repro_torch.privacy.attacks import (ActivationInversionAttack,
                                         delta_to_grad, invert_gradients,
                                         make_prefix_fn,
                                         make_shipped_prefix_fn,
                                         membership_inference,
                                         membership_scores,
                                         plan_boundary_depths)
from repro_torch.privacy.defenses import (DPUplinkStage, RDPAccountant,
                                          dp_epsilon, make_dp_d_step,
                                          make_uplink_stage,
                                          min_feasible_sigma,
                                          rdp_sampled_gaussian,
                                          sigma_for_epsilon)
from repro_torch.privacy.metrics import (attack_advantage, attack_auc,
                                         best_match_psnr,
                                         distance_correlation, psnr, ssim)

__all__ = ["ActivationInversionAttack", "DPUplinkStage", "RDPAccountant",
           "attack_advantage", "attack_auc", "best_match_psnr",
           "delta_to_grad", "distance_correlation", "dp_epsilon",
           "invert_gradients", "make_dp_d_step", "make_prefix_fn",
           "make_shipped_prefix_fn", "make_uplink_stage",
           "membership_inference", "membership_scores", "min_feasible_sigma",
           "plan_boundary_depths", "psnr", "rdp_sampled_gaussian",
           "sigma_for_epsilon", "ssim"]
