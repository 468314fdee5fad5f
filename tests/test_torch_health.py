"""The port's watchtower: health monitors and policy actions
(``repro_torch/obs/health.py``) and cross-run divergence diffing
(``repro_torch/obs/diff.py``), on the CPU at a small width — the twins of
tests/test_obs_health.py without its bench regression gate, which waits
for the port's benchmark.

Inside the port, bit for bit: ``policy='record'`` equals monitors off,
and an injected NaN round under ``policy='rollback'`` commits the last
healthy digest and training continues.  Against JAX: the monitors'
alerts on the same feedback and trees.
"""
import json
import math
import os
from dataclasses import asdict, fields

import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro.config import HealthConfig as JHealthConfig
from repro.control.feedback import RoundFeedback as JRoundFeedback
from repro.obs.health import HealthMonitor as JHealthMonitor
from repro_torch.config import HealthConfig
from repro_torch.configs.registry import get_config
from repro_torch.control.feedback import RoundFeedback
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.obs import (HealthAbort, HealthAlert, HealthMonitor,
                             alert_from_dict, alert_to_dict, diff_runs,
                             load_run)
from repro_torch.obs.diff import main as diff_main
from repro_torch.obs.health import SEV_FATAL, SEV_WARN, worst
from repro_torch.tree import tree_map

SMALL = {"shape.global_batch": 8, "fsl.num_clients": 2,
         "model.dcgan.base_filters": 8}


def _trainer(parts, **over):
    return FSLGANTrainer(get_config("dcgan-mnist").override({**SMALL,
                                                             **over}),
                         parts, seed=0, device="cpu")


def _health_over(out, run_id, policy):
    return {"obs.enabled": True, "obs.out_dir": str(out),
            "obs.run_id": run_id, "obs.health.enabled": True,
            "obs.health.policy": policy}


def _poison(tr):
    """NaN the generator: the next round's fakes, D training and the
    aggregated global D all go non-finite."""
    tr.state.g_params = tree_map(lambda x: x * float("nan"),
                                 tr.state.g_params)


@pytest.fixture(scope="module")
def parts():
    imgs, labels = synthetic_mnist(120, seed=0)
    return partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)


# ---------------------------------------------------------------------------
# monitor unit behavior (no training loop)
# ---------------------------------------------------------------------------

def _mon(**over):
    return HealthMonitor(HealthConfig(enabled=True, **over))


def _fb(r, cls=RoundFeedback, **over):
    base = dict(round_index=r, backend="loop", codec="none", sigma=0.0,
                deadline_s=0.0, split_strategy="sorted_multi",
                up_bytes=1000, down_bytes=1000, lan_bytes=0,
                codec_error=float("nan"), uplink_bps=1e6,
                round_time_s=1.0, clock_s=float(r + 1),
                num_clients=2, stragglers=0, d_loss=0.5, g_loss=0.5)
    base.update(over)
    return cls(**base)


def test_monitor_flags_nonfinite_params():
    bad = {"w": torch.tensor([1.0, float("nan"), float("inf")])}
    a = worst(_mon().check_round(_fb(0), params=bad))
    assert a is not None and a.check == "nonfinite_params"
    assert a.severity == SEV_FATAL and a.recoverable
    assert a.value == 2.0


def test_monitor_nan_loss_is_unmeasured_until_seen_finite():
    mon = _mon()
    assert mon.check_round(_fb(0, d_loss=float("nan"),
                               g_loss=float("nan"))) == []
    assert mon.check_round(_fb(1, g_loss=float("nan"))) == []
    alerts = mon.check_round(_fb(2, d_loss=float("nan"),
                                 g_loss=float("nan")))
    assert [a.check for a in alerts] == ["nonfinite_loss"]
    assert "d_loss" in alerts[0].message
    alerts = _mon().check_round(_fb(0, d_loss=float("inf")))
    assert any(a.check == "nonfinite_loss" for a in alerts)


def test_monitor_loss_ratio_window():
    assert _mon(loss_ratio_max=50.0).check_round(
        _fb(0, d_loss=2.0, g_loss=1.0)) == []
    for d, g in ((100.0, 1.0), (1.0, 100.0)):
        alerts = _mon(loss_ratio_max=50.0).check_round(
            _fb(0, d_loss=d, g_loss=g))
        assert [a.check for a in alerts] == ["loss_ratio"]
        assert alerts[0].severity == SEV_WARN
        assert alerts[0].value == pytest.approx(100.0)


def test_monitor_update_norm_spike_needs_history():
    mon = _mon(window=4, min_history=2, update_norm_factor=10.0)
    base = {"w": torch.zeros(4)}
    small = {"w": torch.full((4,), 0.01)}
    big = {"w": torch.full((4,), 5.0)}
    for r in range(3):
        assert mon.check_round(_fb(r), params=small, update_base=base) == []
    alerts = mon.check_round(_fb(3), params=big, update_base=base)
    assert [a.check for a in alerts] == ["update_norm"]
    assert alerts[0].value > alerts[0].threshold


def test_monitor_codec_error_spike():
    mon = _mon(window=4, min_history=2, codec_error_factor=10.0)
    assert mon.check_round(_fb(0, codec_error=1.0)) == []
    assert mon.check_round(_fb(1, codec_error=1.0)) == []
    alerts = mon.check_round(_fb(2, codec_error=50.0))
    assert [a.check for a in alerts] == ["codec_error_spike"]


def test_monitor_epsilon_overspend_is_fatal_nonrecoverable():
    mon = _mon(epsilon_budget=1.0)
    assert mon.check_round(_fb(0, dp_epsilon=0.5)) == []
    alerts = mon.check_round(_fb(1, dp_epsilon=2.0))
    assert [a.check for a in alerts] == ["epsilon_overspend"]
    assert alerts[0].severity == SEV_FATAL and not alerts[0].recoverable
    assert _mon().check_round(_fb(0, dp_epsilon=2.0)) == []


def test_monitor_straggler_runaway_needs_full_hot_window():
    mon = _mon(window=3, min_history=2, straggler_rate_max=0.5)
    hot = dict(num_clients=2, stragglers=2)
    assert mon.check_round(_fb(0, **hot)) == []
    assert mon.check_round(_fb(1, **hot)) == []
    alerts = mon.check_round(_fb(2, **hot))
    assert [a.check for a in alerts] == ["straggler_runaway"]
    assert mon.check_round(_fb(3, num_clients=2, stragglers=0)) == []
    assert mon.check_round(_fb(4, **hot)) == []


def test_alert_roundtrips_through_dicts():
    a = HealthAlert(3, "nonfinite_params", SEV_FATAL, 7.0, 0.0, "boom",
                    recoverable=False)
    assert alert_from_dict(json.loads(json.dumps(alert_to_dict(a)))) == a


def test_monitor_alerts_match_jax():
    """The same feedback sequence and trees through both monitors: the same
    alerts, field for field (the port's tree scans run in torch)."""
    over = dict(window=3, min_history=2, update_norm_factor=3.0,
                codec_error_factor=4.0, loss_ratio_max=20.0,
                epsilon_budget=2.0, straggler_rate_max=0.4)
    ours = _mon(**over)
    ref = JHealthMonitor(JHealthConfig(enabled=True, **over))
    rng = np.random.default_rng(0)
    base = {"a": np.zeros((5, 3), np.float32), "b": np.zeros(7, np.float32)}
    seq = [dict(codec_error=0.1, dp_epsilon=0.5),
           dict(codec_error=0.12, stragglers=1, d_loss=float("nan")),
           dict(codec_error=0.9, stragglers=1, dp_epsilon=1.5, g_loss=30.0),
           dict(stragglers=2, dp_epsilon=2.5, d_loss=float("inf")),
           dict(codec_error=0.1, stragglers=1)]
    for r, fields_ in enumerate(seq):
        scale = 10.0 if r == 3 else 0.1
        tree = {k: (v + scale * rng.standard_normal(v.shape)).astype(
            np.float32) for k, v in base.items()}
        if r == 4:
            tree["b"][2] = np.nan
        got = ours.check_round(
            _fb(r, **fields_),
            params={k: torch.from_numpy(v) for k, v in tree.items()},
            update_base={k: torch.from_numpy(v) for k, v in base.items()})
        want = ref.check_round(_fb(r, cls=JRoundFeedback, **fields_),
                               params=tree, update_base=base)
        assert [a.check for a in got] == [a.check for a in want], r
        for a, b in zip(got, want):
            da, db = asdict(a), asdict(b)
            np.testing.assert_allclose(da.pop("value"), db.pop("value"),
                                       rtol=1e-6)
            np.testing.assert_allclose(da.pop("threshold"),
                                       db.pop("threshold"), rtol=1e-6)
            assert (da["check"], da["severity"], da["recoverable"]) \
                == (db["check"], db["severity"], db["recoverable"])


# ---------------------------------------------------------------------------
# injected-fault policy pins (the trainer acting on alerts)
# ---------------------------------------------------------------------------

def test_rollback_restores_last_healthy_digest(tmp_path, parts):
    tr = _trainer(parts, **_health_over(tmp_path, "rb", "rollback"))
    m0 = tr.train_epoch(batches_per_client=2)
    assert math.isfinite(m0["d_loss"])
    _poison(tr)
    m1 = tr.train_epoch(batches_per_client=2)
    assert not math.isfinite(m1["d_loss"])
    m2 = tr.train_epoch(batches_per_client=2)
    assert math.isfinite(m2["d_loss"])
    rec = load_run(os.path.join(str(tmp_path), "rb"))
    d0, d1, d2 = rec.digests
    assert d1.rolled_back and not d0.rolled_back and not d2.rolled_back
    assert d1.global_digest == d0.global_digest
    assert d1.opt_digest == d0.opt_digest
    assert d1.gan_digest == d0.gan_digest
    assert d1.aggregated_digest not in ("", d1.global_digest)
    assert d2.global_digest != d1.global_digest
    assert any(a.check == "nonfinite_params" and a.round_index == 1
               and a.severity == SEV_FATAL and a.recoverable
               for a in rec.alerts)


def test_abort_policy_raises_after_recording(tmp_path, parts):
    tr = _trainer(parts, **_health_over(tmp_path, "ab", "abort"))
    tr.train_epoch(batches_per_client=2)
    _poison(tr)
    with pytest.raises(HealthAbort) as exc:
        tr.train_epoch(batches_per_client=2)
    assert exc.value.alert.severity == SEV_FATAL
    assert exc.value.alert.round_index == 1
    rec = load_run(os.path.join(str(tmp_path), "ab"))
    assert rec.num_rounds == 2
    assert len(rec.digests) == 2 and not rec.digests[1].rolled_back
    assert any(a.severity == SEV_FATAL and a.round_index == 1
               for a in rec.alerts)


def test_warn_policy_warns_and_trains_on(tmp_path, parts):
    tr = _trainer(parts, **_health_over(tmp_path, "wn", "warn"))
    tr.train_epoch(batches_per_client=2)
    _poison(tr)
    with pytest.warns(RuntimeWarning, match="nonfinite"):
        tr.train_epoch(batches_per_client=2)
    rec = load_run(os.path.join(str(tmp_path), "wn"))
    assert not rec.digests[1].rolled_back
    assert rec.digests[1].global_digest != rec.digests[0].global_digest


def test_record_policy_is_bit_exact_with_monitors_off(parts):
    tr_on = _trainer(parts, **{"obs.health.enabled": True,
                               "obs.health.policy": "record"})
    tr_off = _trainer(parts)
    for _ in range(2):
        assert tr_on.train_epoch(batches_per_client=2) \
            == tr_off.train_epoch(batches_per_client=2)
    assert tr_on.health_alerts == []
    for on, off in ((tr_on.state.d_params, tr_off.state.d_params),
                    (tr_on.state.g_params, tr_off.state.g_params)):
        assert tree_map(torch.equal, on, off) == tree_map(lambda _: True, on)


def test_record_policy_logs_without_acting(parts):
    tr = _trainer(parts, **{"obs.health.enabled": True,
                            "obs.health.policy": "record"})
    tr.train_epoch(batches_per_client=2)
    _poison(tr)
    tr.train_epoch(batches_per_client=2)
    assert any(a.severity == SEV_FATAL for a in tr.health_alerts)


# ---------------------------------------------------------------------------
# diff: cross-run divergence localization pins
# ---------------------------------------------------------------------------

def _run(out, run_id, parts, n_rounds=2, perturb_after=None, **over):
    tr = _trainer(parts, **{"obs.enabled": True, "obs.out_dir": str(out),
                            "obs.run_id": run_id, **over})
    for r in range(n_rounds):
        tr.train_epoch(batches_per_client=2)
        if perturb_after == r:
            tr.state.d_params = tree_map(lambda x: x * (1.0 + 1e-3),
                                         tr.state.d_params)
    return os.path.join(str(out), run_id)


def test_diff_identical_runs(tmp_path, parts):
    d = diff_runs(_run(tmp_path, "a", parts), _run(tmp_path, "b", parts))
    assert d.identical and d.kind is None and d.first_divergence is None
    assert d.config_diffs == []
    assert d.replay_ok_a and d.replay_ok_b
    assert "identical" in d.report()


def test_diff_localizes_one_knob_divergence(tmp_path, parts):
    d = diff_runs(_run(tmp_path, "ka", parts),
                  _run(tmp_path, "kb", parts, **{"fed.codec": "fp16"}))
    fd = d.first_divergence
    assert (fd.round_index, fd.field, fd.kind) == (0, "knobs.codec",
                                                   "controller")
    assert (fd.a, fd.b) == ("none", "fp16")
    assert ("fed.codec", "none", "fp16") in d.config_diffs
    assert all(e.kind == "controller" for e in d.entries)
    assert d.replay_ok_a and d.replay_ok_b


def test_diff_classifies_numeric_divergence_at_equal_knobs(tmp_path, parts):
    d = diff_runs(_run(tmp_path, "na", parts),
                  _run(tmp_path, "nb", parts, perturb_after=0))
    fd = d.first_divergence
    assert fd is not None and fd.kind == "numeric"
    assert fd.round_index == 1 and fd.field.startswith("digest.")
    assert d.config_diffs == []
    assert not any(e.kind == "controller" for e in d.entries)
    assert {e.kind for e in d.entries} <= {"numeric", "measurement"}


def test_diff_cli_exit_codes(tmp_path, parts):
    da = _run(tmp_path, "ca", parts, n_rounds=1)
    db = _run(tmp_path, "cb", parts, n_rounds=1, **{"fed.codec": "fp16"})
    assert diff_main([da, da]) == 0
    assert diff_main([da, db]) == 1


def test_health_config_matches_jax_fields():
    """The monitors read the same health settings in both packages."""
    assert [f.name for f in fields(HealthConfig)] \
        == [f.name for f in fields(JHealthConfig)]
    assert asdict(HealthConfig()) == asdict(JHealthConfig())
