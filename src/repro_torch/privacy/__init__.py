"""Privacy subsystem (port of ``repro/privacy``): the defenses.

defenses.py  — DP-SGD (per-example clip + noise via kernels/dp_clip), a
               pre-codec uplink DP stage, and an RDP accountant.

The attacks and metrics wait for ROADMAP Queue A item 9.
"""
from repro_torch.privacy.defenses import (DPUplinkStage, RDPAccountant,
                                          dp_epsilon, make_dp_d_step,
                                          make_uplink_stage,
                                          min_feasible_sigma,
                                          rdp_sampled_gaussian,
                                          sigma_for_epsilon)

__all__ = ["DPUplinkStage", "RDPAccountant", "dp_epsilon", "make_dp_d_step",
           "make_uplink_stage", "min_feasible_sigma", "rdp_sampled_gaussian",
           "sigma_for_epsilon"]
