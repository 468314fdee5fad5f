"""The port's control plane (``repro_torch/control``) and sigma control,
on the CPU at a small width: the twins of tests/test_control.py, and the
port held against the JAX package.

Against JAX, on the same inputs: the controllers' decisions on the same
``RoundFeedback`` sequences (exactly), ``knobs_from_config``,
``predict_codec_bytes``, the privacy metrics the split controller's probe
reads (``distance_correlation``, ``psnr``, ``ssim``, to 1e-6), and a
2-client adaptive split trainer run's knob sequence (the discrete knobs
equal, sigma to 1e-6), at thresholds the measured inputs clear by a wide
margin, so a rounding difference cannot flip a decision.

Inside the port, bit for bit: ``control.mode='frozen'`` equals the run
without a control section, and the adaptive round on the card launches
each kernel as its knobs require (``gpu``).
"""
import math
from dataclasses import asdict, fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import cuda_fp32, one_thread  # noqa: F401

from repro.configs.registry import get_config as jget_config
from repro.control import CodecController as JCodecController
from repro.control import ControlKnobs as JControlKnobs
from repro.control import DeadlineController as JDeadlineController
from repro.control import RoundFeedback as JRoundFeedback
from repro.control import SigmaController as JSigmaController
from repro.control import SplitController as JSplitController
from repro.control import knobs_from_config as jknobs_from_config
from repro.control import make_controllers as jmake_controllers
from repro.core.gan import FSLGANTrainer as JTrainer
from repro.fed.transport import predict_codec_bytes as jpredict_codec_bytes
from repro.privacy import metrics as jmetrics
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_config
from repro_torch.control import (CodecController, ControlKnobs,
                                 DeadlineController, RoundFeedback,
                                 SigmaController, SplitController,
                                 knobs_from_config, make_controllers)
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.core.split import SplitExecution, make_boundary_stage
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.fed.transport import make_codec, predict_codec_bytes
from repro_torch.privacy import metrics
from repro_torch.privacy.defenses import RDPAccountant
from repro_torch.tree import leaves

SMALL = {"shape.global_batch": 8, "fsl.num_clients": 2,
         "model.dcgan.base_filters": 8}


def _cfg(**over):
    return get_config("dcgan-mnist").override({**SMALL, **over})


def _trainer(parts, **over):
    return FSLGANTrainer(_cfg(**over), parts, seed=0, device="cpu")


@pytest.fixture(scope="module")
def parts():
    imgs, labels = synthetic_mnist(120, seed=0)
    return partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)


def _fb(i, *, codec="none", codec_error=float("nan"), sigma=0.0,
        dp_steps=0, dp_epsilon=float("nan"), finish=None, loads=None,
        dcor=None, strategy="sorted_multi", up=1000, speedup=1.0,
        cls=RoundFeedback):
    """Synthetic RoundFeedback for pure controller tests (``cls`` picks
    the package)."""
    return cls(
        round_index=i, backend="loop", codec=codec, sigma=sigma,
        deadline_s=0.0, split_strategy=strategy, up_bytes=up, down_bytes=0,
        lan_bytes=0, codec_error=codec_error, uplink_bps=10e6,
        round_time_s=1.0, clock_s=float(i), client_finish_s=finish or {},
        num_clients=2, stragglers=0, dp_epsilon=dp_epsilon,
        dp_steps=dp_steps, device_loads=loads or {}, boundary_dcor=dcor or {},
        pipeline_speedup=speedup)


def _to_jax(obj, cls):
    """A port feedback or knobs record as the JAX package's class."""
    return cls(**{f.name: getattr(obj, f.name) for f in fields(obj)})


# ---------------------------------------------------------------------------
# frozen mode: measurement without steering
# ---------------------------------------------------------------------------

def test_frozen_default_emits_feedback_and_never_steers(parts):
    t = _trainer(parts)
    assert t.cfg.control.mode == "frozen"
    m = t.train_epoch(batches_per_client=2)
    assert len(t.feedback) == 1
    fb = t.feedback[-1]
    # the record reflects the measurements the metrics already report
    assert fb.up_bytes == int(m["up_mbytes"] * 1e6)
    assert fb.down_bytes == int(m["down_mbytes"] * 1e6)
    assert fb.round_time_s == m["round_time_s"]
    assert fb.codec == "none" and fb.sigma == 0.0 and fb.deadline_s == 0.0
    assert fb.num_clients == 2 and math.isnan(fb.dp_epsilon)
    assert fb.backend == "loop" and fb.shards == 1
    assert fb.backend_probe_us == {}
    assert set(fb.client_finish_s) == {"c0", "c1"}
    assert all(v > 0 for v in fb.client_finish_s.values())
    assert t.knobs == knobs_from_config(t.cfg)
    assert t.engine.codec_name == "none"


def test_frozen_equals_uncontrolled_bit_for_bit(parts):
    """``mode='frozen'`` with every controller named steers nothing: the
    same losses, and the same parameters bit for bit, as the default."""
    frozen = _trainer(parts, **{
        "control.mode": "frozen",
        "control.controllers": ["codec", "sigma", "split", "deadline"],
        "control.epsilon_budget": 1.0, "control.horizon_rounds": 2})
    plain = _trainer(parts)
    for _ in range(2):
        assert frozen.train_epoch(batches_per_client=2) \
            == plain.train_epoch(batches_per_client=2)
    for a, b in zip(leaves(frozen.state.d_params["c0"]),
                    leaves(plain.state.d_params["c0"])):
        assert torch.equal(a, b)
    assert frozen.knobs == plain.knobs == knobs_from_config(plain.cfg)


def test_adaptive_mode_requires_valid_controller_names():
    with pytest.raises(ValueError, match="controllers"):
        _cfg(**{"control.mode": "adaptive",
                "control.controllers": ["codec", "warp"]})


# ---------------------------------------------------------------------------
# codec controller (pure)
# ---------------------------------------------------------------------------

def test_codec_controller_probes_cheapest_first_then_commits():
    leaf_sizes = [1000, 24]
    ctl = CodecController(("none", "fp16", "int8", "topk"), 0.05,
                          leaf_sizes, topk_frac=0.05)
    ranked = ctl.ranked
    assert ranked == sorted(ranked, key=ctl.bytes_of.get)
    assert ranked[0] == "topk"
    knobs = ControlKnobs(codec="none")
    k0 = ctl([], knobs)
    assert k0.codec == "topk"
    hist = [_fb(0, codec="topk", codec_error=0.9)]
    k1 = ctl(hist, k0)
    assert k1.codec == "int8"
    hist.append(_fb(1, codec="int8", codec_error=0.003))
    k2 = ctl(hist, k1)
    assert k2.codec == "int8"
    assert ctl.bytes_of["topk"] < ctl.bytes_of["int8"]
    hist.append(_fb(2, codec="int8", codec_error=0.2))
    assert ctl(hist, k2).codec == "fp16"


def test_codec_controller_all_over_budget_stays_inside_candidates():
    ctl = CodecController(("topk", "int8"), 1e-6, [1000], topk_frac=0.05)
    hist = [_fb(0, codec="topk", codec_error=0.9),
            _fb(1, codec="int8", codec_error=0.1)]
    assert ctl(hist, ControlKnobs(codec="int8")).codec == "int8"
    assert "none" not in ctl.bytes_of


def test_codec_controller_rounds_with_no_uplink_measure_nothing():
    ctl = CodecController(("int8", "none"), 0.05, [100])
    hist = [_fb(0, codec="int8", codec_error=float("nan"))]
    assert ctl(hist, ControlKnobs(codec="int8")).codec == "int8"


def test_predict_codec_bytes_matches_codec_accounting():
    tree = {"w": torch.ones((50, 20)), "b": torch.ones((24,))}
    sizes = [50 * 20, 24]
    for name in ("none", "fp16", "int8", "topk"):
        codec = make_codec(name, topk_frac=0.05, error_feedback=False)
        _, measured = codec.roundtrip(tree)
        assert predict_codec_bytes(name, sizes, topk_frac=0.05) == measured


@pytest.mark.parametrize("name", ["none", "fp16", "int8", "topk"])
@pytest.mark.parametrize("frac", [0.01, 0.05, 0.3])
def test_predict_codec_bytes_matches_jax(name, frac):
    sizes = [1030913, 12544, 24, 1, 64 * 5 * 5]
    assert predict_codec_bytes(name, sizes, topk_frac=frac) \
        == jpredict_codec_bytes(name, sizes, topk_frac=frac)


# ---------------------------------------------------------------------------
# sigma controller (pure + pinned against the accountant)
# ---------------------------------------------------------------------------

def test_sigma_controller_solves_budget_and_self_corrects():
    ctl = SigmaController(4.0, 6, 1e-5, 1.0, steps_per_round_hint=2)
    k0 = ctl([], ControlKnobs(sigma=1.0))
    assert k0.sigma > 1.0
    acct = RDPAccountant(k0.sigma, 1.0)
    hist, k = [], k0
    for r in range(6):
        k = ctl(hist, k)
        acct.step(2, noise_multiplier=k.sigma)
        hist.append(_fb(r, sigma=k.sigma, dp_steps=2,
                        dp_epsilon=acct.epsilon(1e-5)[0]))
    assert acct.epsilon(1e-5)[0] <= 4.0 * (1 + 1e-9)
    assert acct.epsilon(1e-5)[0] > 0.8 * 4.0


def test_sigma_controller_hysteresis_never_relaxes_budget():
    ctl = SigmaController(1.0, 4, 1e-5, 1.0, steps_per_round_hint=1,
                          rel_change=0.5)
    assert ctl([], ControlKnobs(sigma=0.1)).sigma > 0.1


def test_sigma_controller_unreachable_budget_clamps_to_sigma_max():
    ctl = SigmaController(1e-6, 10, 1e-5, 1.0, steps_per_round_hint=100,
                          sigma_max=50.0)
    assert ctl([], ControlKnobs(sigma=1.0)).sigma == 50.0
    ctl2 = SigmaController(2.0, 4, 1e-5, 1.0, steps_per_round_hint=1)
    hist = [_fb(0, sigma=2.0, dp_steps=10), _fb(1, sigma=2.0, dp_steps=2)]
    k_small = ctl2(hist, ControlKnobs(sigma=2.0))
    hist_flat = [_fb(0, sigma=2.0, dp_steps=10),
                 _fb(1, sigma=2.0, dp_steps=10)]
    k_flat = ctl2(hist_flat, ControlKnobs(sigma=2.0))
    assert k_small.sigma >= k_flat.sigma * 0.99


def test_sigma_controller_trainer_run_pinned_against_accountant(parts):
    """A full adaptive run (uplink DP) spends at most the (epsilon, delta)
    budget, per the accountant, and the rebound sigma reaches the live
    uplink stage."""
    budget, horizon = 3.0, 4
    t = _trainer(parts, **{
        "privacy.enabled": True, "privacy.mode": "uplink",
        "privacy.noise_multiplier": 0.7,
        "control.mode": "adaptive", "control.controllers": ["sigma"],
        "control.epsilon_budget": budget, "control.horizon_rounds": horizon})
    for _ in range(horizon):
        m = t.train_epoch(batches_per_client=1)
    assert m["dp_epsilon"] <= budget * (1 + 1e-9)
    assert m["dp_epsilon"] == t.accountant.epsilon(t.cfg.privacy.delta)[0]
    assert t.feedback[-1].sigma != 0.7
    assert t._uplink_stage.noise_multiplier == t.knobs.sigma


def test_rebind_sigma_rebuilds_both_step_caches(parts):
    """``LocalProgram.rebind_sigma`` (sigma control): the DP-SGD program
    drops its loop and vectorized steps and builds the next at the new
    noise scale; the same sigma, or a program without DP-SGD, is a
    no-op."""
    t = _trainer(parts, **{"privacy.enabled": True, "privacy.mode": "dp_sgd",
                           "privacy.noise_multiplier": 0.5})
    prog = t.program
    prog._vstep(None)
    step0 = prog.step
    prog.rebind_sigma(0.5)
    assert prog.step is step0 and None in prog._vstep_cache
    prog.rebind_sigma(2.0)
    assert prog.privacy.noise_multiplier == 2.0
    assert prog.step is not step0 and not prog._vstep_cache
    assert t.cfg.privacy.noise_multiplier == 0.5
    plain = _trainer(parts).program
    step = plain.step
    plain.rebind_sigma(3.0)
    assert plain.step is step and plain.privacy.noise_multiplier == 0.0


def test_sigma_rebind_reaches_dp_sgd_steps(parts):
    """An adaptive DP-SGD run: the program's noise scale follows the
    controller's sigma, and a rebound round differs from the static one
    (the noise scale changed) while an unrebound first round is equal."""
    over = {"privacy.enabled": True, "privacy.mode": "dp_sgd",
            "privacy.noise_multiplier": 0.3}
    ada = _trainer(parts, **over, **{
        "control.mode": "adaptive", "control.controllers": ["sigma"],
        "control.epsilon_budget": 50.0, "control.horizon_rounds": 3})
    static = _trainer(parts, **over)
    ada.train_epoch(batches_per_client=1)
    assert ada.program.privacy.noise_multiplier == ada.knobs.sigma != 0.3
    m_ada = ada.train_epoch(batches_per_client=1)
    static.train_epoch(batches_per_client=1)
    m_static = static.train_epoch(batches_per_client=1)
    assert m_ada["d_loss"] != m_static["d_loss"]


# ---------------------------------------------------------------------------
# deadline controller (pure + engine application)
# ---------------------------------------------------------------------------

def test_deadline_controller_takes_quantile_of_measured_finishes():
    ctl = DeadlineController(quantile=0.75, slack=1.2, warmup=1)
    hist = [_fb(0, finish={"c0": 10.0, "c1": 20.0, "c2": 30.0,
                           "c3": 1000.0})]
    assert ctl(hist, ControlKnobs()).deadline_s == pytest.approx(36.0)
    assert DeadlineController(warmup=2)(hist, ControlKnobs()).deadline_s \
        == 0.0


def test_deadline_controller_reaches_engine(parts):
    t = _trainer(parts, **{
        "fed.client_local_steps": {"c1": 4}, "control.mode": "adaptive",
        "control.controllers": ["deadline"],
        "control.deadline_quantile": 0.5, "control.deadline_slack": 1.05})
    t.train_epoch(batches_per_client=1)
    m = t.train_epoch(batches_per_client=1)
    assert t.engine.deadline_s > 0
    assert t.engine.deadline_s == t.knobs.deadline_s
    assert m["stragglers"] >= 1.0


# ---------------------------------------------------------------------------
# split controller (pure + regroup integration)
# ---------------------------------------------------------------------------

def test_split_controller_pure_decisions():
    ctl = SplitController(imbalance_threshold=1.5, dcor_threshold=0.5,
                          replan_strategy="sorted_multi", leaky_stage="dp")
    knobs = ControlKnobs(split_strategy="random_single")
    hist = [_fb(0, loads={"d0": 1.0, "d1": 1.0},
                dcor={"c0": (0.2, 0.1)}, strategy="random_single")]
    k = ctl(hist, knobs)
    assert k is knobs and k.stage_by_boundary is None
    hist = [_fb(0, loads={"d0": 10.0, "d1": 1.0},
                dcor={"c0": (0.9, 0.2), "c1": (0.7,)},
                strategy="random_single")]
    k = ctl(hist, knobs)
    assert k.split_strategy == "sorted_multi"
    assert k.stage_by_boundary == {0: "dp", 1: "identity"}


def test_split_controller_regroups_trainer_and_keeps_training(parts):
    t = _trainer(parts, **{
        "split.enabled": True, "fsl.selection": "random_single",
        "split.stage_sigma": 0.3, "split.stage_clip": 5.0,
        "control.mode": "adaptive", "control.controllers": ["split"],
        "control.imbalance_threshold": 1.2,
        "control.dcor_threshold": 0.3, "control.probe_batch": 8})
    t.train_epoch(batches_per_client=1)
    sigs0 = {cid: ex.signature for cid, ex in t.split_execs.items()}
    assert t.feedback[-1].boundary_dcor
    m1 = t.train_epoch(batches_per_client=1)
    assert t.knobs.split_strategy == "sorted_multi"
    assert t.knobs.stage_by_boundary is not None
    assert any(t.split_execs[cid].signature != sigs0.get(cid)
               for cid in t.split_execs)
    assert np.isfinite(m1["d_loss"]) and m1["num_clients"] == 2.0
    for ex in t.split_execs.values():
        assert len(ex.stages) == ex.num_boundaries
    m2 = t.train_epoch(batches_per_client=1)
    stage_map2 = dict(t.knobs.stage_by_boundary)
    assert set(stage_map2.values()) == {"dp"}
    eng2 = t.engine
    m3 = t.train_epoch(batches_per_client=1)
    assert dict(t.knobs.stage_by_boundary or {}) == stage_map2
    assert t.engine is eng2
    assert np.isfinite(m2["d_loss"]) and np.isfinite(m3["d_loss"])


def test_per_boundary_stages_price_and_sign_independently(parts):
    t = _trainer(parts, **{"split.enabled": True})
    cid = max(t.split_execs, key=lambda c: t.split_execs[c].num_boundaries)
    ex = t.split_execs[cid]
    nb = ex.num_boundaries
    assert nb >= 2
    mixed = [make_boundary_stage(t.cfg.split, "int8" if b == 0 else
                                 "identity") for b in range(nb)]
    ex2 = SplitExecution(ex.plan, ex.apply_layer, ex.tails, stages=mixed)
    assert ex2.signature != ex.signature
    x_shape = (t.batch_size, 28, 28, 1)
    tot_id, per_id = ex.step_wire_bytes(t.state.d_params[cid], x_shape)
    tot_mix, per_mix = ex2.step_wire_bytes(t.state.d_params[cid], x_shape)
    assert per_mix[0]["fwd"] < per_id[0]["fwd"]
    assert per_mix[1:] == per_id[1:]
    assert tot_mix < tot_id
    ex3 = SplitExecution(ex.plan, ex.apply_layer, ex.tails,
                         stages=[make_boundary_stage(t.cfg.split,
                                                     "identity")] * nb)
    real = torch.from_numpy(parts[cid][: t.batch_size])
    l1, g1 = ex.value_and_grad(t.state.d_params[cid], real, real)
    l3, g3 = ex3.value_and_grad(t.state.d_params[cid], real, real)
    assert float(l1) == float(l3)
    for a, b in zip(leaves(g1), leaves(g3)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# adaptive codec, end to end through the engine
# ---------------------------------------------------------------------------

def test_adaptive_codec_commits_within_budget_and_beats_lossless(parts):
    rounds = 3
    t = _trainer(parts, **{"control.mode": "adaptive",
                           "control.controllers": ["codec"],
                           "control.error_budget": 0.05,
                           "fed.topk_frac": 0.01})
    for _ in range(rounds):
        t.train_epoch(batches_per_client=1)
    trace = [fb.codec for fb in t.feedback]
    assert trace[0] == "topk" and trace[-1] == "int8"
    assert t.engine.codec_name == "int8"
    assert t.feedback[-1].codec_error <= 0.05
    t_none = _trainer(parts)
    for _ in range(rounds):
        t_none.train_epoch(batches_per_client=1)
    assert t.engine.ledger.total_up < t_none.engine.ledger.total_up


def test_suite_order_and_factory_names():
    cfg = _cfg(**{"control.mode": "adaptive",
                  "control.controllers": ["deadline", "codec", "sigma"],
                  "control.epsilon_budget": 1.0,
                  "control.horizon_rounds": 2})
    assert make_controllers(cfg, leaf_sizes=[10]).names \
        == ("codec", "sigma", "deadline")


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

CONFIGS = {
    "default": {},
    "adaptive": {"fed.codec": "int8", "fed.topk_frac": 0.05,
                 "fed.deadline_s": 12.5, "privacy.enabled": True,
                 "privacy.noise_multiplier": 1.7,
                 "split.strategy": "random_single",
                 "control.mode": "adaptive",
                 "control.controllers": ["codec", "sigma", "split",
                                         "deadline"]},
    "selection": {"fsl.selection": "sorted_single"},
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_knobs_from_config_matches_jax(case):
    over = {**SMALL, **CONFIGS[case]}
    got = knobs_from_config(get_config("dcgan-mnist").override(over))
    want = jknobs_from_config(jget_config("dcgan-mnist").override(over))
    assert asdict(got) == asdict(want)


def _histories():
    """Feedback sequences that walk every branch of the four controllers:
    codec probes over and under budget and a drift, DP releases of
    changing length, imbalanced and balanced loads, leaky and quiet
    boundaries, finish times under a changing pipeline schedule."""
    codec = [_fb(0, codec="topk", codec_error=0.9, up=900),
             _fb(1, codec="int8", codec_error=0.003, up=4000),
             _fb(2, codec="int8", codec_error=float("nan")),
             _fb(3, codec="int8", codec_error=0.2)]
    sigma = [_fb(r, sigma=s, dp_steps=n, dp_epsilon=e)
             for r, (s, n, e) in enumerate([(1.0, 4, 0.8), (1.3, 2, 1.1),
                                            (1.3, 6, 1.9), (2.2, 0, 1.9)])]
    split = [_fb(0, loads={"d0": 10.0, "d1": 1.0, "d2": 2.0},
                 dcor={"c0": (0.9, 0.2), "c1": (0.7,)},
                 strategy="random_single"),
             _fb(1, loads={"d0": 1.0, "d1": 1.0},
                 dcor={"c0": (0.1, 0.2)}),
             _fb(2, loads={"d0": 3.0}, dcor={"c0": (0.2, 0.8, 0.95)})]
    deadline = [_fb(r, finish={f"c{i}": 10.0 * (i + 1) * (r + 1)
                               for i in range(4)}, speedup=sp)
                for r, sp in enumerate([1.0, 1.0, 2.5, 2.5, 1.8, 1.0])]
    return {"codec": codec, "sigma": sigma, "split": split,
            "deadline": deadline, "mixed": codec + sigma + split}


@pytest.mark.parametrize("hist_name", ["codec", "sigma", "split",
                                       "deadline", "mixed"])
def test_controller_suite_decisions_match_jax(hist_name):
    """The whole suite of a config naming all four controllers, folded
    over the same feedback sequence from the same knobs: every decision
    equal to the JAX suite's, field for field."""
    over = {**SMALL, "control.mode": "adaptive",
            "control.controllers": ["codec", "sigma", "split", "deadline"],
            "control.epsilon_budget": 3.0, "control.horizon_rounds": 8,
            "control.error_budget": 0.05, "control.dcor_threshold": 0.5,
            "control.imbalance_threshold": 1.5,
            "control.deadline_quantile": 0.75, "privacy.enabled": True,
            "privacy.noise_multiplier": 1.0, "fed.topk_frac": 0.05}
    sizes = [1000, 24, 400, 7]
    suite = make_controllers(get_config("dcgan-mnist").override(over),
                             leaf_sizes=sizes, steps_per_round_hint=3)
    jsuite = jmake_controllers(jget_config("dcgan-mnist").override(over),
                               leaf_sizes=sizes, steps_per_round_hint=3)
    assert suite.names == jsuite.names
    hist = _histories()[hist_name]
    knobs = ControlKnobs(codec="none", sigma=1.0,
                         split_strategy="random_single")
    jknobs = _to_jax(knobs, JControlKnobs)
    for r in range(len(hist) + 1):
        knobs = suite(hist[:r], knobs)
        jknobs = jsuite([_to_jax(fb, JRoundFeedback) for fb in hist[:r]],
                        jknobs)
        assert asdict(knobs) == asdict(jknobs), r


@pytest.mark.parametrize("ctl,jctl", [
    (lambda: CodecController(("topk", "int8", "fp16", "none"), 0.01,
                             [1000, 24], target_uplink_s=0.01),
     lambda: JCodecController(("topk", "int8", "fp16", "none"), 0.01,
                              [1000, 24], target_uplink_s=0.01)),
    (lambda: SigmaController(1e-6, 10, 1e-5, 0.1, sigma_max=50.0),
     lambda: JSigmaController(1e-6, 10, 1e-5, 0.1, sigma_max=50.0)),
    (lambda: SplitController(imbalance_threshold=1.1, leaky_stage="int8"),
     lambda: JSplitController(imbalance_threshold=1.1, leaky_stage="int8")),
    (lambda: DeadlineController(quantile=0.3, slack=1.0, warmup=2,
                                window=2),
     lambda: JDeadlineController(quantile=0.3, slack=1.0, warmup=2,
                                 window=2)),
], ids=["codec_target_uplink", "sigma_unreachable", "split_int8",
        "deadline_window"])
def test_each_controller_matches_jax(ctl, jctl):
    ours, ref = ctl(), jctl()
    for hist in _histories().values():
        knobs = ControlKnobs(codec="fp16", sigma=0.5, deadline_s=40.0,
                             split_strategy="random_single")
        jknobs = _to_jax(knobs, JControlKnobs)
        for r in range(len(hist) + 1):
            knobs = ours(hist[:r], knobs)
            jknobs = ref([_to_jax(fb, JRoundFeedback) for fb in hist[:r]],
                         jknobs)
            assert asdict(knobs) == asdict(jknobs), r


def _images(seed, shape=(4, 28, 28, 1)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _dcor64(x, y):
    """The reference's distance correlation formula in float64 numpy."""
    def centered(v):
        v = v.reshape(v.shape[0], -1).astype(np.float64)
        sq = np.sum(v * v, axis=1)
        d = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * v @ v.T,
                               0.0) + 1e-12)
        return (d - d.mean(0, keepdims=True) - d.mean(1, keepdims=True)
                + d.mean())
    xa, yb = centered(x), centered(y)
    den = np.sqrt(np.mean(xa * xa) * np.mean(yb * yb))
    if not den > 0:
        return 0.0
    return float(np.sqrt(max(np.mean(xa * yb), 0.0) / max(den, 1e-12)))


def test_privacy_metrics_match_jax():
    """The split controller's dCor probe and the reconstruction metrics:
    psnr, ssim and best_match_psnr equal to the JAX package's to 1e-6 on
    the same inputs; the membership statistics exactly.  The distance
    correlation is the reference's formula evaluated in float64: equal to
    a float64 numpy evaluation to 1e-9 (float64 rounding through the same
    cancellation), and away from the JAX value by
    no more than the JAX value's own float32 rounding (up to ~2e-6 near
    dCor 1, from the distance matrix's cancelling diagonal)."""
    a, b = _images(0), _images(1)
    near = a + 0.05 * _images(2)
    for x, y in ((a, b), (a, near)):
        np.testing.assert_allclose(metrics.psnr(x, y), jmetrics.psnr(x, y),
                                   rtol=1e-6)
        np.testing.assert_allclose(metrics.ssim(x, y), jmetrics.ssim(x, y),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(metrics.best_match_psnr(near, a),
                               jmetrics.best_match_psnr(near, a), rtol=1e-6)
    assert metrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")
    act = np.tanh(a.reshape(4, -1) @ _images(3, (784, 32)))
    wide = np.random.default_rng(7).uniform(-1, 1, (16, 28, 28, 1)).astype(
        np.float32)
    relu = np.maximum(wide.reshape(16, -1) @ _images(9, (784, 512)), 0.0)
    for x, y in ((a, act), (a, b), (a, 2.0 * a + 1.0), (a, np.zeros_like(a)),
                 (wide, relu)):
        got = metrics.distance_correlation(torch.from_numpy(x),
                                           torch.from_numpy(y))
        exact = _dcor64(x, y)
        ref = jmetrics.distance_correlation(jnp.asarray(x), jnp.asarray(y))
        assert abs(got - exact) <= 1e-9
        assert abs(got - ref) <= abs(ref - exact) + 1e-9 <= 5e-6
    m, n = _images(4, (50,)), _images(5, (40,))
    assert metrics.attack_auc(m, n) == jmetrics.attack_auc(m, n)
    assert metrics.attack_advantage(torch.from_numpy(m), n) \
        == jmetrics.attack_advantage(m, n)


ADAPTIVE_RUN = {
    "fsl.selection": "random_single", "split.enabled": True,
    "split.stage_clip": 5.0, "split.stage_sigma": 0.5,
    "privacy.enabled": True, "privacy.mode": "uplink",
    "privacy.noise_multiplier": 1.0, "fed.client_local_steps": {"c1": 3},
    "control.mode": "adaptive",
    "control.controllers": ["codec", "sigma", "split", "deadline"],
    # the measured inputs clear each threshold by a wide margin: top-k
    # errors ~0.95 and int8 ~0.009 against 0.05, dCor ~0.98 against 0.3,
    # device loads from the (equal) plans
    "control.error_budget": 0.05, "control.epsilon_budget": 4.0,
    "control.horizon_rounds": 3, "control.imbalance_threshold": 1.2,
    "control.dcor_threshold": 0.3, "control.deadline_quantile": 0.5,
    "control.deadline_slack": 1.6, "control.probe_batch": 8}


def test_adaptive_split_run_knobs_match_jax(parts):
    """A 2-client adaptive run with all four controllers (uplink DP, the
    executed split, a straggler) from the JAX trainer's parameters: each
    round's codec, split strategy, per-boundary stages and deadline equal
    to the JAX trainer's, sigma to 1e-6, and every controller acts."""
    over = {**SMALL, **ADAPTIVE_RUN}
    jtr = JTrainer(jget_config("dcgan-mnist").override(over), parts, seed=0)
    tr = FSLGANTrainer(get_config("dcgan-mnist").override(over), parts,
                       seed=0, device="cpu")
    cid0 = jtr.client_ids[0]
    tr.state.g_params = params_from_numpy(
        jax.tree.map(np.asarray, jtr.state.g_params), "cpu")
    tr.state.d_params = {cid: params_from_numpy(
        jax.tree.map(np.asarray, jtr.state.d_params[cid0]), "cpu")
        for cid in tr.client_ids}
    seq, jseq = [], []
    for _ in range(3):
        tr.train_epoch(batches_per_client=1)
        jtr.train_epoch(batches_per_client=1)
        seq.append(tr.knobs)
        jseq.append(jtr.knobs)
    for k, jk in zip(seq, jseq):
        a, b = asdict(k), asdict(jk)
        np.testing.assert_allclose(a.pop("sigma"), b.pop("sigma"), rtol=1e-6)
        assert a == b
    first, last = seq[0], seq[-1]
    assert first.codec == "topk" and last.codec == "int8"
    assert last.split_strategy == "sorted_multi"
    assert last.stage_by_boundary and last.deadline_s > 0
    assert first.sigma != 1.0


# ---------------------------------------------------------------------------
# the card (gpu)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_adaptive_round_launches_the_knobs_kernels_on_gpu(cuda_fp32, parts):
    """An adaptive round on the card (codec and sigma controllers,
    DP-SGD through the dp_clip kernel, the int8 stream reduce through
    dequant_acc): round 0 probes top-k (scatter_acc, one launch a
    client's fold), round 1 commits int8 (dequant_acc); dp_clip once a
    client a step, fedavg never (the stream reduce)."""
    from repro_torch.kernels.agg_fuse.kernel import (
        dequant_acc_leaves_kernel, scatter_acc_leaves_kernel)
    from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
    tr = FSLGANTrainer(_cfg(**{
        "privacy.enabled": True, "privacy.mode": "dp_sgd",
        "privacy.use_kernel": True, "fed.server_reduce": "stream",
        "fed.kernel_aggregation": True, "control.mode": "adaptive",
        "control.controllers": ["codec", "sigma"],
        "control.epsilon_budget": 40.0, "control.horizon_rounds": 2}),
        parts, seed=0, device="cuda")
    kernels = (scatter_acc_leaves_kernel, dequant_acc_leaves_kernel,
               dp_clip_noise_kernel)
    for r, want in enumerate([(2, 0, 4), (0, 2, 4)]):
        before = [k.launches for k in kernels]
        m = tr.train_epoch(batches_per_client=2)
        torch.cuda.synchronize()
        got = tuple(k.launches - b for k, b in zip(kernels, before))
        assert got == want, (r, tr.knobs.codec)
        assert np.isfinite(m["d_loss"])
    assert [fb.codec for fb in tr.feedback] == ["topk", "int8"]
    assert tr.program.privacy.noise_multiplier == tr.knobs.sigma
