"""The port's example scripts (``repro_torch/examples``) on the CPU at their
smallest arguments: one round, batch 8, base_filters 8.  Each returns and
writes its artifacts under ``tmp_path``."""
import json
import os

import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro_torch.examples import (adaptive_control_demo,
                                  device_selection_demo, fed_async_demo,
                                  federated_lm, fsl_gan_mnist,
                                  privacy_frontier_demo, quickstart,
                                  serve_demo, split_training_demo,
                                  trace_viewer_demo)
from repro_torch.obs import load_run

SMALL = ["--batch-size", "8", "--base-filters", "8", "--device", "cpu"]


def _out(tmp_path):
    return ["--out", str(tmp_path)]


def test_fsl_gan_mnist(tmp_path):
    res = fsl_gan_mnist.main(["--epochs", "1", "--clients", "2",
                              "--batches-per-client", "1", "--examples",
                              "200", *SMALL, *_out(tmp_path)])
    assert res["total_disc_steps"] == 2 and res["device"] == "cpu"
    assert np.isfinite(res["history"][0]["d_loss"])
    gen = np.load(tmp_path / "generated.npy")
    assert gen.shape == (64, 28, 28, 1) and np.abs(gen).max() <= 1.0
    with open(tmp_path / "history.json") as f:
        assert json.load(f)["mean_image_mse"] == res["mean_image_mse"]


def test_fed_async_demo(tmp_path):
    totals = fed_async_demo.main(["--epochs", "1", "--clients", "2",
                                  "--batches-per-client", "1", *SMALL,
                                  *_out(tmp_path)])
    assert set(totals) == set(fed_async_demo.SCENARIOS)
    # the int8 and top-k uplinks ship fewer bytes than the fp32 one
    assert totals["fedasync+int8"]["up_mbytes"] \
        < totals["sync"]["up_mbytes"]
    with open(tmp_path / "fed_async.json") as f:
        assert json.load(f) == totals


def test_device_selection_demo(tmp_path):
    plans = device_selection_demo.main(_out(tmp_path))
    assert set(plans) == {"random_single", "random_multi", "sorted_single",
                          "sorted_multi"}
    assert all(p["epoch_s"] > 0 for p in plans.values())
    assert os.path.exists(tmp_path / "device_selection.json")


def test_serve_demo(tmp_path):
    tokens = serve_demo.main(["--requests", "2", "--gen-tokens", "2",
                              "--device", "cpu", *_out(tmp_path)])
    assert sorted(tokens) == [0, 1]
    assert all(len(t) == 2 for t in tokens.values())
    assert os.path.exists(tmp_path / "serve.json")


def test_quickstart(tmp_path):
    res = quickstart.main(["--rounds", "1", *SMALL, *_out(tmp_path)])
    assert len(res["strategy_sweep"]) == 4
    assert len(res["fsl_gan"]) == 1
    assert np.isfinite(res["fsl_gan"][0]["g_loss"])
    # the third demo: two olmoe-1b-7b train steps, with the MoE's aux loss
    assert len(res["lm_substrate"]) == 2
    assert all(np.isfinite(s["loss"]) and s["aux_loss"] > 0
               for s in res["lm_substrate"])
    assert os.path.exists(tmp_path / "quickstart.json")


def test_federated_lm(tmp_path):
    """Cadences k = 1 and 4 over 4 steps: 4 FedAvg rounds against 1, a
    quarter of the parameter traffic."""
    res = federated_lm.main(["--arch", "qwen3-14b", "--clients", "2",
                             "--steps", "4", "--device", "cpu",
                             *_out(tmp_path)])
    k1, k4 = res["local_steps=1"], res["local_steps=4"]
    assert (k1["fedavg_rounds"], k4["fedavg_rounds"]) == (4, 1)
    assert k4["param_mib"] == pytest.approx(k1["param_mib"] / 4)
    assert all(np.isfinite(k1["losses"] + k4["losses"]))
    # both cadences start from the same replicas on the same batches
    assert k1["losses"][0] == k4["losses"][0]
    with open(tmp_path / "federated_lm.json") as f:
        assert json.load(f) == res


def test_adaptive_control_demo(tmp_path):
    res = adaptive_control_demo.main(["--rounds", "1", *SMALL,
                                      *_out(tmp_path)])
    assert res.matches and len(res.decisions) == 1
    rec = load_run(os.path.join(str(tmp_path), "obs_runs", "adaptive-demo"))
    assert rec.num_rounds == 1
    assert rec.knobs[0].codec == "topk"       # the cheapest probe first


def test_trace_viewer_demo(tmp_path):
    counts = trace_viewer_demo.main(["--rounds", "1", *SMALL,
                                     *_out(tmp_path)])
    assert counts["events"] > 0 and counts["boundary"] > 0
    assert os.path.exists(os.path.join(str(tmp_path), "obs_runs",
                                       "trace-demo", "trace.json"))


def test_privacy_frontier_demo(tmp_path):
    res = privacy_frontier_demo.main(
        ["--epochs", "1", "--batches-per-client", "1", "--examples", "200",
         "--inversion-steps", "3", "--decoder-steps", "3", *SMALL,
         *_out(tmp_path)])
    assert res["device"] == "cpu"
    assert np.isfinite(res["gradient_inversion"]["psnr"])
    assert res["activation_inversion"]
    assert 0.0 <= res["membership"]["auc"] <= 1.0
    assert np.isfinite(res["defended"]["epsilon"])
    with open(tmp_path / "privacy_frontier.json") as f:
        assert json.load(f)["membership"]["auc"] == res["membership"]["auc"]


def test_split_training_demo(tmp_path):
    res = split_training_demo.main(["--batches", "1", "--decoder-steps", "2",
                                    *SMALL, *_out(tmp_path)])
    assert res["device"] == "cpu" and res["lan_bytes"] > 0
    stages = {row["stage"] for row in res["leakage"]}
    assert stages == set(split_training_demo.STAGES)
    # the int8 wire is a quarter of the fp32 one, plus its scale
    wire = {(row["stage"], row["boundary"]): row["wire_bytes"]
            for row in res["leakage"]}
    assert all(wire["int8", b] < wire["identity", b] for s, b in wire
               if s == "identity")
    assert os.path.exists(os.path.join(str(tmp_path), "obs_runs",
                                       "split-demo-identity", "trace.json"))
