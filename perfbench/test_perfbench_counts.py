"""The yardstick's counts against hand counts, and the trace arithmetic."""
import math

import pytest

from perfbench import common, flops
from perfbench.trace import breakdown, busy_union

DCGAN = common.load_json(common.BENCH_DIR / "configs" / "dcgan-mnist.json")
OLMOE = common.load_json(common.BENCH_DIR / "configs" / "olmoe-1b-7b.json")


def test_dcgan_discriminator_forward_by_hand():
    # conv0 14x14x64 outputs of 5x5x1, conv1 7x7x128 of 5x5x64, conv2
    # 4x4x256 of 5x5x128, the classifier 4096 -> 1
    macs = 196 * 64 * 25 + 49 * 128 * 25 * 64 + 16 * 256 * 25 * 128 + 4096
    assert flops.dcgan_disc_forward(DCGAN["model"]) == 2 * macs


def test_dcgan_generator_forward_by_hand():
    # proj 100 -> 7x7x256; deconv0 7x7x256 input pixels x 25 x 128; deconv1
    # 14x14x128 x 25 x 64; out 28x28 x 25 x 64 -> 1
    macs = 100 * 12544 + 49 * 256 * 25 * 128 + 196 * 128 * 25 * 64 \
        + 784 * 25 * 64
    assert flops.dcgan_gen_forward(DCGAN["model"]) == 2 * macs


def test_dcgan_round_by_hand():
    d = flops.dcgan_disc_forward(DCGAN["model"])
    g = flops.dcgan_gen_forward(DCGAN["model"])
    want = 5 * 4 * 256 * g + 5 * 4 * 512 * 3 * d + 4 * 256 * 3 * (g + d)
    got = flops.fsl_gan_round(DCGAN["model"], batch=256, clients=5, steps=4)
    assert got == want
    assert 2.9e12 < got < 3.0e12


def test_discriminator_parameter_count():
    from perfbench.drivers import fsl_gan
    import torch
    _, d = fsl_gan.init_weights(DCGAN, 1, torch.device("cpu"))
    n = sum(t.numel() for _, t in common.named_leaves(d))
    assert n == DCGAN["discriminator_params"] == 1_030_913


def test_olmoe_counts_by_hand():
    m = OLMOE["model"]
    per_layer = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024
    active = 4 * per_layer + 2048 * 50304
    assert flops.moe_active_matmul_params(m) == active
    attn = 4 * 4 * 6 * 4096 ** 2 * 2048
    assert flops.lm_train_step(m, batch=4, seq_len=4096) \
        == 6 * active * 4 * 4096 + attn


def test_olmoe_parameter_count():
    from perfbench.drivers import lm_train
    shapes = lm_train.param_shapes(OLMOE["model"])
    n = sum(math.prod(s) for s, _ in shapes.values())
    assert n == 1_884_310_528


def test_dp_clip_terms_by_hand():
    t = flops.dp_clip_terms(256, 1_030_913)
    assert t["bytes_accessed"] == 4 * (256 * 1_030_913 + 2 * 1_030_913)
    assert t["bound"] == "memory"
    assert t["t_bound_s"] == pytest.approx(t["bytes_accessed"] / 3.35e12)


def test_busy_union_merges_overlaps():
    total, merged = busy_union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 10)])
    assert merged == [(0, 3), (5, 9), (10, 10)]
    assert total == 7


def test_breakdown_clips_to_the_slice_and_names_gaps():
    device = [("a", 0.0, 10.0), ("b", 20.0, 12.0), ("a", 35.0, 10.0)]
    labels = [("step", 0.0, 50.0), ("client", 28.0, 10.0)]
    bd = breakdown(device, labels, 5.0, 40.0)
    assert bd["busy_s"] == pytest.approx(22e-6)
    assert bd["device_ops"][0] == ["b", pytest.approx(12e-6)]
    assert [g[0] for g in bd["idle_gaps"]] == ["step", "client"]
    assert bd["idle_gaps"][0][1] == pytest.approx(10e-6)
