"""The port's vectorized client backend, ``backend="auto"`` and the client
mesh, on the CPU at a small width.

Inside the port, the twins of the reference's pins
(tests/test_fed_runtime.py): the stacked round equals the per-client loop
at the reference's fp32 tolerances (d_loss 1e-5, parameters 5e-5), not bit
for bit, because a convolution vmapped over clients is a grouped
convolution that sums in another order.  The BN-fed D biases (conv1.b,
conv2.b) are skipped there as the reference skips them: their gradient is
rounding noise that Adam turns into steps of about lr (ROADMAP Queue C).
Against the JAX package, the port's vectorized round is held to the
existing parity rule of tests/test_torch_trainer.py.

The kernels' CUDA paths run only on a GPU: those tests carry the ``gpu``
marker and skip here.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_fixtures import cuda_fp32, one_thread  # noqa: F401
from _torch_parity import close_to_reference
from _torch_parity import paths as _paths
from jax.sharding import AbstractMesh

from repro.configs.registry import get_config as jget_config
from repro.core.gan import FSLGANTrainer as JTrainer
from repro.sharding import specs as jspecs
from repro_torch import keys
from repro_torch.configs.registry import get_config
from repro_torch.core import gan as tgan
from repro_torch.core.gan import FSLGANTrainer
from repro_torch.data import partition_dirichlet, synthetic_mnist
from repro_torch.device import fp32_convolutions
from repro_torch.fed.aggregate import batched_reduce
from repro_torch.fed.programs import (BACKENDS, RoundExecutor,
                                      sequential_d_rounds, stack_trees,
                                      unstack_tree)
from repro_torch.fed.transport import make_codec
from repro_torch.launch.mesh import Mesh, make_client_mesh, mesh_chips
from repro_torch.sharding import specs as tspecs
from repro_torch.tree import leaves, tree_map

ROUNDS, BATCHES = 2, 2
SMALL = {"shape.global_batch": 8, "fsl.num_clients": 2,
         "model.dcgan.base_filters": 8}
# the reference's tolerances (tests/test_fed_runtime.py)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-5, atol=5e-5)
DEAD_BIASES = {("conv1", "b"), ("conv2", "b")}
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def parts():
    imgs, labels = synthetic_mnist(120, seed=0)
    return partition_dirichlet(imgs, labels, 2, alpha=0.5, seed=0)


@pytest.fixture(scope="module")
def parts3():
    # 3 clients of the paper pool: split signatures (2,) for c0 and c2 and
    # (2, 3) for c1, so a stacked group of 2 and one of 1
    imgs, labels = synthetic_mnist(180, seed=0)
    return partition_dirichlet(imgs, labels, 3, alpha=0.5, seed=0)


def _trainer(parts, over):
    clients = {"fsl.num_clients": len(parts)}
    return FSLGANTrainer(get_config("dcgan-mnist").override(
        {**SMALL, **clients, **over}), parts, seed=0, device="cpu")


def _d_trees_close(ta, tb):
    """Every client's D of two trainers at the reference's tolerances
    (its ``_d_param_trees_close``), the dead biases skipped."""
    for cid in ta.state.d_params:
        da, db = ta.state.d_params[cid], tb.state.d_params[cid]
        for path, a, b in zip(_paths(da), leaves(da), leaves(db)):
            if path not in DEAD_BIASES:
                np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                           **PARAM_TOL,
                                           err_msg=f"{cid}/{path}")


def _rng_state(tr):
    return tr._rng.bit_generator.state


# ---------------------------------------------------------------------------
# vectorized == loop, inside the port
# ---------------------------------------------------------------------------

def test_run_vectorized_matches_sequential_d_rounds(parts):
    """Twin of test_vectorized_round_matches_sequential: the stacked
    program over (C, T, B, ...) batches against the per-client loop of
    the trainer's D step, from each client's own start."""
    tr = _trainer(parts, {})
    st = tr.state
    active = tr._active_clients()
    b, t = tr.batch_size, 2
    reals = torch.stack([torch.stack([tr._sample_real(cid, b)
                                      for _ in range(t)]) for cid in active])
    fakes = torch.stack([torch.stack([tr._gen(st.g_params, tr._z(b))
                                      for _ in range(t)]) for cid in active])
    sp = stack_trees([st.d_params[c] for c in active])
    so = stack_trees([st.d_opt[c] for c in active])
    vp, vo, v_losses = tr.program.run_vectorized(sp, so, reals, fakes)
    seq_p, seq_o, s_losses = sequential_d_rounds(
        tr._d_step, [st.d_params[c] for c in active],
        [st.d_opt[c] for c in active], reals, fakes)
    assert v_losses.shape == (len(active), t)
    np.testing.assert_allclose(v_losses.numpy(), s_losses.numpy(),
                               **LOSS_TOL)
    for got, want, got_o, want_o in zip(unstack_tree(vp, len(active)), seq_p,
                                        unstack_tree(vo, len(active)), seq_o):
        for path, a, w in zip(_paths(got), leaves(got), leaves(want)):
            if path not in DEAD_BIASES:
                np.testing.assert_allclose(a.numpy(), w.numpy(), **PARAM_TOL,
                                           err_msg=str(path))
        assert int(got_o["step"]) == int(want_o["step"]) == t


# name -> (overrides, per-example crossing tolerance of the parameters)
CASES = {
    "plain": ({}, None),
    "dp_sgd": ({"privacy.enabled": True,
                "privacy.noise_multiplier": 0.8}, None),
    "split": ({"split.enabled": True}, None),
    "split_int8_dp": ({"split.enabled": True,
                       "split.boundary_stage": "int8+dp"}, None),
    "split_pipelined": ({"split.enabled": True,
                         "split.boundary_stage": "int8+dp",
                         "split.pipeline_microbatches": 4}, None),
    # DP-SGD through the split: each example crosses alone, so a vmapped
    # convolution's rounding that flips one int8 quantum moves that
    # example's gradient by up to 1/127 of the leaf's largest, fp16 by
    # 1e-3 (ROADMAP Queue C)
    "dp_sgd_split_int8": ({"privacy.enabled": True,
                           "privacy.noise_multiplier": 0.8,
                           "split.enabled": True,
                           "split.boundary_stage": "int8+dp"}, 1 / 127),
    "dp_sgd_split_fp16": ({"privacy.enabled": True,
                           "privacy.noise_multiplier": 0.8,
                           "split.enabled": True,
                           "split.boundary_stage": "fp16+dp"}, 1e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_vectorized_backend_matches_loop(parts3, case):
    """Twins of test_engine_vectorized_backend_matches_loop,
    test_looped_dp_matches_vectorized_dp_fixed_seed and
    test_split_vectorized_backend_matches_loop, over 3 clients (split: two
    signatures, a stacked group of 2): 2 rounds under each backend from
    the same start, noise on where the path draws it.  d_loss at 1e-5,
    every client's D at 5e-5 (per-example crossings: of each leaf's
    largest, at the crossing's tolerance), and exactly equal: clients,
    bytes, epsilon, accountant steps and the host RNG stream."""
    over, ex_tol = CASES[case]
    ta, tb = _trainer(parts3, over), _trainer(parts3, over)
    if "split.enabled" in over:
        sigs = [ta.program.signature_for(c) for c in ta._active_clients()]
        assert len(set(sigs)) == 2 and len(sigs) == 3
    for _ in range(ROUNDS):
        ma = ta.train_epoch(batches_per_client=BATCHES, backend="loop")
        mb = tb.train_epoch(batches_per_client=BATCHES, backend="vectorized")
        np.testing.assert_allclose(ma["d_loss"], mb["d_loss"], **LOSS_TOL)
        for k in set(ma) - {"d_loss", "g_loss"}:
            assert ma[k] == mb[k], k
        assert _rng_state(ta) == _rng_state(tb)
    if ta.accountant is not None:
        assert ta.accountant.steps == tb.accountant.steps \
            == ROUNDS * BATCHES * 3
    if ex_tol is None:
        _d_trees_close(ta, tb)
        return
    start = _trainer(parts3, over).state.d_params["c0"]
    da, db = ta.state.d_params["c0"], tb.state.d_params["c0"]
    for path, s, a, b in zip(_paths(da), leaves(start), leaves(da),
                             leaves(db)):
        if path not in DEAD_BIASES:
            scale = float((s - a).abs().max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=ex_tol * scale + 5e-5,
                                       err_msg=str(path))


@pytest.mark.parametrize("steps", [{"c1": 1}, {"c0": 1, "c1": 2}])
def test_masked_steps_match_the_loop(parts, steps):
    """A ``local_steps`` schedule of 1 and 2 batches: the shorter client's
    padding step is masked (its state and loss untouched), and the round
    equals the loop's."""
    over = {"fed.client_local_steps": steps}
    ta, tb = _trainer(parts, over), _trainer(parts, over)
    for _ in range(ROUNDS):
        ma = ta.train_epoch(batches_per_client=2, backend="loop")
        mb = tb.train_epoch(batches_per_client=2, backend="vectorized")
        np.testing.assert_allclose(ma["d_loss"], mb["d_loss"], **LOSS_TOL)
        assert _rng_state(ta) == _rng_state(tb)
    for cid, s in steps.items():
        assert int(tb.state.d_opt[cid]["step"]) == ROUNDS * s
        assert len(tb.engine.last_report.client_infos[
            tb._active_clients().index(cid)][1]["losses"]) == s
    _d_trees_close(ta, tb)


def test_run_vectorized_masked_slot_keeps_state(parts):
    """A False slot of the (C, T) mask leaves that client's parameters and
    optimizer state as they were and reports a 0 loss."""
    tr = _trainer(parts, {})
    st = tr.state
    x = torch.stack([torch.stack([tr._sample_real(c, 8)])
                     for c in ("c0", "c1")])
    sp = stack_trees([st.d_params["c0"]] * 2)
    so = stack_trees([st.d_opt["c0"]] * 2)
    p, o, losses = tr.program.run_vectorized(
        sp, so, x, x, mask=[[True], [False]])
    assert float(losses[1, 0]) == 0.0 and float(losses[0, 0]) != 0.0
    for a, b in zip(leaves(p), leaves(sp)):
        assert torch.equal(a[1], b[1]) and not torch.equal(a[0], b[0])
    assert o["step"].tolist() == [1, 0]


@pytest.mark.parametrize("steps", [{"c0": 1}, {"c0": 1, "c1": 2}])
def test_masked_schedule_calls_dp_clip_once_a_step_taken(parts, steps,
                                                         monkeypatch):
    """Under a ``local_steps`` schedule the vectorized DP-SGD round calls
    dp_clip once a client a step it takes (the sum of the steps, the
    loop's count), not once a client a padded step: a masked slot runs no
    part of the step."""
    from repro_torch.kernels.dp_clip import ops
    calls, real = [], ops.dp_clip_noise_tree

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "dp_clip_noise_tree", counted)
    over = {"privacy.enabled": True, "privacy.noise_multiplier": 0.8,
            "fed.client_local_steps": steps}
    counts = {}
    for backend in BACKENDS:
        tr = _trainer(parts, over)
        calls.clear()
        tr.train_epoch(batches_per_client=2, backend=backend)
        counts[backend] = len(calls)
    want = sum(steps.get(cid, 2) for cid in ("c0", "c1"))
    assert counts == {"loop": want, "vectorized": want}


# ---------------------------------------------------------------------------
# the split's client-mapped forms against the per-client loop
# ---------------------------------------------------------------------------

def _split_exec(parts3, stage, k=1):
    tr = _trainer(parts3, {"split.enabled": True,
                           "split.boundary_stage": stage,
                           "split.stage_sigma": 0.5,
                           "split.pipeline_microbatches": k})
    return tr, tr.split_execs["c0"]


def _client_batches(tr, c=2, b=8, seed=3):
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (c, b, 28, 28, 1)).astype(np.float32)
    fake = np.tanh(rng.standard_normal((c, b, 28, 28, 1))).astype(np.float32)
    g = torch.Generator().manual_seed(seed)
    params = [tree_map(lambda p: p + 0.01 * torch.randn(
        p.shape, generator=g).to(p.device), tr.state.d_params["c0"])
        for _ in range(c)]
    ks = [keys.fold_in(keys.root(keys.STAGE, 1), i) for i in range(c)]
    return params, torch.tensor(real), torch.tensor(fake), ks


@pytest.mark.parametrize("stage,k", [("identity", 1), ("int8+dp", 1),
                                     ("fp16+dp", 2), ("topk+dp", 1)])
def test_clients_value_and_grad_matches_each_client(parts3, stage, k):
    """The staged step over a client axis (each crossing's stage per
    client, on its row, with its key; pipelined at K = 2) against each
    client's own ``value_and_grad`` with the same key, stage noise on:
    losses at 1e-5, gradients at 1e-5 of each leaf's largest (through a
    lossy codec, 1e-4: the grouped convolution can flip a quantum)."""
    tr, ex = _split_exec(parts3, stage, k)
    params, real, fake, ks = _client_batches(tr)
    losses, grads = ex.clients_value_and_grad(stack_trees(params), real,
                                              fake, ks)
    tol = 1e-5 if stage == "identity" else 1e-4
    for c, (p, key) in enumerate(zip(params, ks)):
        l, g = ex.value_and_grad(p, real[c], fake[c], key)
        np.testing.assert_allclose(float(losses[c]), float(l), rtol=tol)
        top = max(float(w.abs().max()) for w in leaves(g))
        for path, a, w in zip(_paths(g), leaves(grads), leaves(g)):
            scale = top if path in DEAD_BIASES else float(w.abs().max())
            np.testing.assert_allclose(a[c].numpy(), w.numpy(), rtol=0,
                                       atol=tol * scale, err_msg=str(path))


@pytest.mark.parametrize("stage", ["int8+dp", "fp16+dp", "dp", "identity"])
def test_clients_per_example_matches_each_client(parts3, stage):
    """The per-example staged step over a client axis (one per-example
    stage call a crossing for the whole group, each client's (B, N) noise
    from its own crossing key) against each client's
    ``per_example_value_and_grad`` with its key, stage noise on: losses at
    1e-5 (1e-3 through a codec), per-example gradients at the Queue C
    tolerances of each leaf's largest (int8 1/127, fp16 1e-3, else
    1e-5)."""
    tr, ex = _split_exec(parts3, stage)
    params, real, fake, ks = _client_batches(tr, b=5)
    losses, grads = ex.clients_per_example_value_and_grad(
        stack_trees(params), real, fake, ks)
    assert losses.shape == (2, 5)
    codec = stage.split("+")[0]
    tol = {"int8": 1 / 127, "fp16": 1e-3}.get(codec, 1e-5)
    for c, (p, key) in enumerate(zip(params, ks)):
        l, g = ex.per_example_value_and_grad(p, real[c], fake[c], key)
        np.testing.assert_allclose(losses[c].numpy(), l.numpy(),
                                   rtol=1e-3 if tol > 1e-5 else 1e-5)
        top = max(float(w.abs().max()) for w in leaves(g))
        for path, a, w in zip(_paths(g), leaves(grads), leaves(g)):
            scale = top if path in DEAD_BIASES else float(w.abs().max())
            np.testing.assert_allclose(a[c].numpy(), w.numpy(), rtol=0,
                                       atol=tol * scale, err_msg=str(path))


# ---------------------------------------------------------------------------
# against the JAX package's vectorized round
# ---------------------------------------------------------------------------

# noise off (the port's noise streams are not JAX's), the clips bind
JAX_CASES = {
    "plain": {},
    "dp_sgd": {"privacy.enabled": True, "privacy.mode": "dp_sgd",
               "privacy.clip_norm": 0.1, "privacy.noise_multiplier": 0.0},
    "split_int8_dp": {"split.enabled": True,
                      "split.boundary_stage": "int8+dp",
                      "split.stage_sigma": 0.0},
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_vectorized_round_matches_jax_vectorized(parts, case):
    """The port's vectorized round against the JAX trainer's vectorized
    round (its dp_clip as the plain reference inside the jitted program)
    from the same parameters: losses at 1e-4 relative, every other metric
    exactly, parameters to the parity rule of tests/test_torch_trainer.py
    (``close_to_reference``): D and G at 1e-4 absolute, BN-fed biases
    within lr x Adam steps of their start.  Through the int8 split alone,
    G is held to the rule's ``noise_steps`` form: 336 of the 266,240
    crossing codes come out one quantum apart from JAX's (an input within
    rounding of a tie; the two codecs agree on equal inputs, as the next
    test holds), and the kinks that those flips move make G's gradient
    jump: 6 of 156,800 elements of G proj.w end 1.1e-4 to 1.9e-4 apart."""
    from repro_torch.bridge import params_from_numpy
    over = {**SMALL, **JAX_CASES[case], "fed.backend": "vectorized"}
    jtr = JTrainer(jget_config("dcgan-mnist").override(over), parts, seed=0)
    cid0 = jtr.client_ids[0]
    g0, d0 = _np(jtr.state.g_params), _np(jtr.state.d_params[cid0])
    tr = _trainer(parts, over)
    tr.state.g_params = params_from_numpy(g0, CPU)
    tr.state.d_params = {cid: params_from_numpy(d0, CPU)
                         for cid in tr.client_ids}
    for _ in range(ROUNDS):
        jm = jtr.train_epoch(batches_per_client=BATCHES)
        m = tr.train_epoch(batches_per_client=BATCHES)
        assert set(m) == set(jm)
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
        for k in set(m) - {"d_loss", "g_loss"}:
            assert m[k] == jm[k], k
    drift = tr.cfg.optim.lr * ROUNDS * BATCHES
    close_to_reference(tr.state.g_params, _np(jtr.state.g_params), g0, drift,
                       noise_steps=(case == "split_int8_dp"))
    close_to_reference(tr.state.d_params[cid0],
                       _np(jtr.state.d_params[cid0]), d0, drift)


def test_split_int8_dp_g_step_and_codec_match_jax_on_equal_inputs(
        parts, monkeypatch):
    """Where the split int8+dp round's G drift starts, held tight: the
    port's ``_g_step`` fed the JAX trainer's own inputs of each of its
    vectorized round's G steps (G, the averaged D, z) computes JAX's loss
    at 1e-6 relative and JAX's G gradient on every leaf at 1e-6 absolute
    plus 1e-5 relative (the sum order's share: measured at most 7.5e-8
    on proj.w, whose elements drift, and 1.8e-6 on out.w, where |g|
    reaches 0.56); and on every int8 crossing input of the port's
    vectorized round, the two packages' ``codec_qdq`` give equal codes
    and scales (dequantized values equal bit for bit; JAX's taken a row
    at a time where the port's amax is a row's).  What is left for the
    end-of-round pin is the inputs' own rounding, which the
    ``noise_steps`` rule bounds."""
    from repro.core.gan import g_loss_fn as jg_loss_fn
    from repro.kernels.boundary_fuse.ref import codec_qdq as jcodec_qdq
    from repro_torch.bridge import params_from_numpy
    from repro_torch.kernels.boundary_fuse import ops as tbf_ops
    from repro_torch.kernels.boundary_fuse.ref import codec_qdq
    from repro_torch.optim.optimizers import Optimizer
    over = {**SMALL, **JAX_CASES["split_int8_dp"], "fed.backend": "vectorized"}
    jtr = JTrainer(jget_config("dcgan-mnist").override(over), parts, seed=0)
    g0, d0 = (_np(jtr.state.g_params),
              _np(jtr.state.d_params[jtr.client_ids[0]]))
    steps, jg_step = [], jtr._g_step

    def record(g, o, d, z):
        loss, grads = jax.value_and_grad(jg_loss_fn)(g, d, z, jtr.c)
        steps.append(_np((g, d, z, loss, grads)))
        return jg_step(g, o, d, z)

    jtr._g_step = record
    tr = _trainer(parts, over)
    tr.state.g_params = params_from_numpy(g0, CPU)
    tr.state.d_params = {cid: params_from_numpy(d0, CPU)
                         for cid in tr.client_ids}
    crossings, fused = [], tbf_ops.fused_boundary_flat

    def record_crossing(x, *a, codec="none", amax="tensor", **kw):
        if codec == "int8":
            crossings.append((x.detach().clone(), amax))
        return fused(x, *a, codec=codec, amax=amax, **kw)

    monkeypatch.setattr(tbf_ops, "fused_boundary_flat", record_crossing)
    for _ in range(ROUNDS):
        jtr.train_epoch(batches_per_client=BATCHES)
        tr.train_epoch(batches_per_client=BATCHES)
    assert len(steps) == ROUNDS * BATCHES
    assert len(crossings) > 0

    grads_seen = []
    opt = tr.g_optimizer
    tr.g_optimizer = Optimizer(init=opt.init, update=lambda grads, *a: (
        grads_seen.append(grads) or opt.update(grads, *a)))
    for i, (g, d, z, loss, grads) in enumerate(steps):
        *_, got_loss = tr._g_step(params_from_numpy(g, CPU), tr.state.g_opt,
                                  params_from_numpy(d, CPU),
                                  torch.from_numpy(z.copy()))
        np.testing.assert_allclose(float(got_loss), loss, rtol=1e-6,
                                   err_msg=f"G step {i}")
        assert len(grads_seen) == i + 1
        got = grads_seen[-1]
        for path, a, b in zip(_paths(got), leaves(got),
                              jax.tree.leaves(grads)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6,
                                       err_msg=f"G step {i} {path}")

    for i, (x, amax) in enumerate(crossings):
        want = (jax.vmap(lambda r: jcodec_qdq(r, "int8")) if amax == "row"
                else lambda t: jcodec_qdq(t, "int8"))(x.numpy())
        np.testing.assert_array_equal(codec_qdq(x, "int8", amax).numpy(),
                                      np.asarray(want),
                                      err_msg=f"crossing {i} ({amax})")


# ---------------------------------------------------------------------------
# backend="auto"
# ---------------------------------------------------------------------------

def test_auto_backend_probes_once_and_pins_its_pick(parts):
    """Twin of test_trainer_auto_backend_and_pipeline_feedback: the first
    round probes both backends once and picks one, its feedback carrying
    the probe times and the pipeline fields; later rounds reuse the pick
    without probing; the probe draws no host RNG and commits nothing, so
    the round equals the picked backend's round from the same start."""
    over = {"split.enabled": True, "split.pipeline_microbatches": 2,
            "fed.backend": "auto"}
    tr = _trainer(parts, over)
    m = tr.train_epoch(batches_per_client=1)
    pick = tr._auto_backend
    fb = tr.feedback[-1]
    assert pick in BACKENDS and fb.backend == pick
    assert set(fb.backend_probe_us) == set(BACKENDS)
    assert all(v > 0 for v in fb.backend_probe_us.values())
    assert fb.pipeline_microbatches == 2 and fb.pipeline_speedup >= 1.0
    ref = _trainer(parts, over)
    mr = ref.train_epoch(batches_per_client=1, backend=pick)
    np.testing.assert_allclose(m["d_loss"], mr["d_loss"], **LOSS_TOL)
    assert _rng_state(tr) == _rng_state(ref)
    assert int(tr.state.d_opt["c0"]["step"]) == 1
    tr.train_epoch(batches_per_client=1)
    assert tr._auto_backend == pick == tr.feedback[-1].backend
    assert not tr.feedback[-1].backend_probe_us
    assert tr._resolve_auto_backend(1) == (pick, {})


# ---------------------------------------------------------------------------
# the client mesh and the sharding specs
# ---------------------------------------------------------------------------

def _amesh(n, axis="clients"):
    return AbstractMesh((n,), (axis,))


def _tmesh(n, axis="clients"):
    return Mesh((CPU,) * n, (axis,))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shape", [(8, 3), (6, 3), (4,), (1, 5), (12, 2, 2)])
def test_logical_spec_matches_reference(n, shape):
    """Divisible and ragged client counts: the spec of the reference's
    ``logical_spec`` (a count the axis does not divide replicates)."""
    logical = ("clients",) + (None,) * (len(shape) - 1)
    want = jspecs.logical_spec(_amesh(n), jspecs.client_axis_rules(
        _amesh(n)), shape, logical)
    got = tspecs.logical_spec(_tmesh(n), tspecs.client_axis_rules(
        _tmesh(n)), shape, logical)
    assert tuple(got) == tuple(want)


def test_client_axis_rules_fall_back_without_clients_axis():
    for mk, specs in ((_amesh, jspecs), (_tmesh, tspecs)):
        m = mk(2, "data")
        rules = specs.client_axis_rules(m)
        assert rules.mesh_axes_for("clients") is None
        assert tuple(specs.logical_spec(m, rules, (8,), ("clients",))) == ()
    assert tspecs.client_chunks(_tmesh(2, "data"), 8) is None


@pytest.mark.parametrize("c", [8, 6, 4])
def test_stacked_shardings_match_reference(c):
    tree = {"w": np.zeros((c, 3, 3), np.float32),
            "b": {"x": np.zeros((c,), np.float32)}}
    want = jspecs.stacked_shardings(_amesh(4), jax.tree.map(jax.numpy.asarray,
                                                            tree))
    got = tspecs.stacked_shardings(_tmesh(4), tree_map(torch.tensor, tree))
    assert _paths(got) == _paths(tree)
    for path, g in zip(_paths(got), leaves(got)):
        w = want[path[0]] if len(path) == 1 else want[path[0]][path[1]]
        assert g.mesh == _tmesh(4) and tuple(g.spec) == tuple(w.spec)


def test_tree_shardings_rejects_structure_mismatch():
    tree = {"a": torch.zeros((2, 2))}
    bad = {"a": tspecs.Lg("clients", None), "extra": tspecs.Lg(None)}
    with pytest.raises(ValueError, match="mismatch"):
        tspecs.tree_shardings(_tmesh(2), tspecs.client_axis_rules(
            _tmesh(2)), tree, bad)


def test_client_chunks_and_mesh():
    assert tspecs.client_chunks(_tmesh(2), 6) == [(CPU, 0, 3), (CPU, 3, 6)]
    assert tspecs.client_chunks(_tmesh(2), 5) is None      # ragged
    assert tspecs.client_chunks(_tmesh(1), 4) is None      # one device
    assert _tmesh(3).shape == {"clients": 3}
    m = make_client_mesh(device_type="cpu")
    assert m.axis_names == ("clients",) and mesh_chips(m) == 1
    assert mesh_chips(make_client_mesh(max_devices=1)) == 1
    for bad in (((CPU,) * 2, ("data", "clients")), ((), ("clients",))):
        with pytest.raises(ValueError):
            Mesh(*bad)


@pytest.mark.parametrize("over", [
    {}, {"privacy.enabled": True, "privacy.noise_multiplier": 0.8},
    {"fed.codec": "int8", "fed.server_reduce": "batched"}])
def test_two_device_mesh_round_equals_unsharded(parts, over, monkeypatch):
    """``fed.shard_clients`` over a mesh of two devices built directly
    from (cpu, cpu): each client's chunk runs on its device and comes back
    for the reduce; the batched reduce cuts the wires the same way.  The
    rounds equal the unsharded vectorized rounds at the reference's
    tolerances; the trainer reports 2 shards.  On one device there is no
    mesh (1 shard)."""
    base = {**over, "fed.backend": "vectorized"}
    one = _trainer(parts, {**base, "fed.shard_clients": True})
    assert one._client_mesh() is None and one._num_shards("vectorized") == 1
    mesh = _tmesh(2)
    monkeypatch.setattr(tgan, "make_client_mesh", lambda **kw: mesh)
    ta, tb = _trainer(parts, base), _trainer(parts, {
        **base, "fed.shard_clients": True})
    for _ in range(ROUNDS):
        ma = ta.train_epoch(batches_per_client=BATCHES)
        mb = tb.train_epoch(batches_per_client=BATCHES)
        np.testing.assert_allclose(ma["d_loss"], mb["d_loss"], **LOSS_TOL)
        for k in set(ma) - {"d_loss", "g_loss", "codec_error"}:
            assert ma[k] == mb[k], k
    assert tb._num_shards("vectorized") == 2
    assert tb._num_shards("loop") == 1
    assert tb.engine.mesh is (mesh if "fed.server_reduce" in over else None)
    _d_trees_close(ta, tb)


@pytest.mark.parametrize("codec", ["int8", "fp16", "topk"])
def test_batched_reduce_on_a_mesh_matches_one_device(codec):
    """The batched reduce over a (cpu, cpu) mesh (each device its chunk of
    the 4 clients, chunk means weighted by their weight sums) against the
    one-device reduce: within 1e-6 (the mean is summed in another order);
    a ragged count (3 clients) is the one-device reduce itself."""
    g = torch.Generator().manual_seed(0)
    template = {"w": torch.zeros((30, 7)), "b": torch.zeros((5,))}
    cdc = make_codec(codec, topk_frac=0.2, error_feedback=False)
    encs = [cdc.encode_tree(tree_map(lambda t: torch.randn(
        t.shape, generator=g), template))[0] for _ in range(4)]
    w = [1.0, 2.0, 3.0, 4.0]
    want = batched_reduce(codec, encs, w, template)
    got = batched_reduce(codec, encs, w, template, mesh=_tmesh(2))
    for a, b in zip(leaves(got), leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for a, b in zip(leaves(batched_reduce(codec, encs[:3], w[:3], template,
                                          mesh=_tmesh(2))),
                    leaves(batched_reduce(codec, encs[:3], w[:3],
                                          template))):
        assert torch.equal(a, b)


def test_shard_stacked_cuts_contiguous_chunks(parts):
    tr = _trainer(parts, {})
    ex = RoundExecutor(tr.program, backend="vectorized", sample=None,
                       opt_lookup=None, default_steps=1, mesh=_tmesh(2))
    x = torch.arange(8.0).reshape(4, 2)
    got = ex._shard_stacked(({"a": x}, x))
    assert [(d, lo, hi) for d, lo, hi, _ in got] == [(CPU, 0, 2),
                                                     (CPU, 2, 4)]
    assert torch.equal(got[1][3][0]["a"], x[2:]) and torch.equal(
        got[0][3][1], x[:2])
    whole = ex._shard_stacked((x[:3],))
    assert len(whole) == 1 and whole[0][:3] == (CPU, 0, 3)


def test_unknown_backend_raises(parts):
    tr = _trainer(parts, {})
    with pytest.raises(ValueError, match="backend"):
        tr.train_epoch(batches_per_client=1, backend="stacked")


# ---------------------------------------------------------------------------
# fp32 convolutions at the trainer's entry points
# ---------------------------------------------------------------------------

def test_fp32_convolutions_restores_the_flag():
    was = torch.backends.cudnn.allow_tf32
    try:
        for outer in (True, False):
            torch.backends.cudnn.allow_tf32 = outer
            with fp32_convolutions():
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is outer
            with pytest.raises(KeyError):
                with fp32_convolutions():
                    raise KeyError
            assert torch.backends.cudnn.allow_tf32 is outer
        assert torch.backends.cudnn.enabled
    finally:
        torch.backends.cudnn.allow_tf32 = was


@pytest.mark.parametrize("entry", ["train_epoch", "train_epoch_sequential",
                                   "generate"])
def test_entry_points_run_with_tf32_off(parts, monkeypatch, entry):
    """With the global flag on, the convolutions of every entry point see
    it off (recorded at each generator and discriminator application),
    cuDNN stays enabled, and the flag reads on again afterwards."""
    seen = []
    for name in ("gen_apply", "disc_apply"):
        orig = getattr(tgan, name)

        def spy(*a, orig=orig, **kw):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cudnn.enabled))
            return orig(*a, **kw)
        monkeypatch.setattr(tgan, name, spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    tr = _trainer(parts, {})
    tr._build_steps()           # rebind the steps to the spies
    if entry == "generate":
        tr.generate(2)
    else:
        getattr(tr, entry)(batches_per_client=1)
    assert seen and set(seen) == {(False, True)}
    assert torch.backends.cudnn.allow_tf32 is True


# ---------------------------------------------------------------------------
# every backend x privacy x codec cell, and async under the vectorized
# backend (tests/test_fed_runtime.py's matrix)
# ---------------------------------------------------------------------------

MATRIX_PRIVACY = {
    "none": {},
    "dp_sgd": {"privacy.enabled": True, "privacy.noise_multiplier": 0.5},
    "uplink": {"privacy.enabled": True, "privacy.mode": "uplink",
               "privacy.noise_multiplier": 0.5},
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("privacy", sorted(MATRIX_PRIVACY))
@pytest.mark.parametrize("codec", ["none", "fp16", "int8", "topk"])
def test_backend_privacy_codec_matrix(parts, backend, privacy, codec):
    over = {"fed.codec": codec, "fed.topk_frac": 0.25,
            **MATRIX_PRIVACY[privacy]}
    m = _trainer(parts, over).train_epoch(batches_per_client=1,
                                          backend=backend)
    assert np.isfinite(m["d_loss"]) and np.isfinite(m["g_loss"])
    assert m["num_clients"] == 2.0
    if privacy == "none":
        assert "dp_epsilon" not in m
    else:
        assert 0 < m["dp_epsilon"] < float("inf")


@pytest.mark.parametrize("mode", ["fedasync", "fedbuff"])
def test_async_scheduling_composes_with_vectorized_and_dp(parts, mode):
    """Async modes run the program per arrival under the vectorized
    backend, DP-SGD included: 2 clients x 2 cycles x 1 batch releases."""
    tr = _trainer(parts, {"fed.mode": mode, "fed.async_cycles": 2,
                          "privacy.enabled": True,
                          "privacy.noise_multiplier": 0.5})
    m = tr.train_epoch(batches_per_client=1, backend="vectorized")
    assert np.isfinite(m["d_loss"]) and m["num_clients"] == 2.0
    assert tr.accountant.steps == 4


# ---------------------------------------------------------------------------
# the CUDA paths (GPU only)
# ---------------------------------------------------------------------------

def _gpu_trainer(parts3, over, device):
    return FSLGANTrainer(get_config("dcgan-mnist").override(
        {**SMALL, "fsl.num_clients": 3, **over}), parts3, seed=0,
        device=device)


@pytest.mark.gpu
def test_vectorized_dp_step_launches_dp_clip_once_a_client_a_step(
        parts3, cuda_fp32):
    """The vectorized DP-SGD round on the card: one dp_clip launch a
    client a step (3 x 2), one fedavg launch a round reading the stacked
    output's rows in place, and the round equal to the loop's."""
    from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
    from repro_torch.kernels.fedavg.kernel import fedavg_leaves_kernel
    over = {"privacy.enabled": True, "privacy.noise_multiplier": 0.8,
            "privacy.use_kernel": True, "fed.kernel_aggregation": True}
    ta = _gpu_trainer(parts3, over, cuda_fp32)
    tb = _gpu_trainer(parts3, over, cuda_fp32)
    ma = ta.train_epoch(batches_per_client=BATCHES, backend="loop")
    d0, f0 = dp_clip_noise_kernel.launches, fedavg_leaves_kernel.launches
    mb = tb.train_epoch(batches_per_client=BATCHES, backend="vectorized")
    assert (dp_clip_noise_kernel.launches - d0,
            fedavg_leaves_kernel.launches - f0) == (3 * BATCHES, 1)
    np.testing.assert_allclose(ma["d_loss"], mb["d_loss"], **LOSS_TOL)
    assert ma["dp_epsilon"] == mb["dp_epsilon"]
    _d_trees_close(ta, tb)


@pytest.mark.gpu
def test_vectorized_masked_schedule_launches_the_loops_kernels(
        parts3, cuda_fp32):
    """A ``local_steps`` schedule of 1 for c0 under the vectorized DP-SGD
    split on the card: dp_clip launches once a client a step taken (5, not
    3 x 2), and each signature group's per-example crossings launch
    boundary_fuse once a crossing a step any of its clients takes."""
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    from repro_torch.kernels.dp_clip.kernel import dp_clip_noise_kernel
    tr = _gpu_trainer(parts3, {
        "privacy.enabled": True, "privacy.noise_multiplier": 0.8,
        "privacy.use_kernel": True, "split.enabled": True,
        "split.boundary_stage": "int8+dp", "split.stage_sigma": 0.5,
        "split.use_kernel": True, "fed.client_local_steps": {"c0": 1}},
        cuda_fp32)
    d0, b0 = dp_clip_noise_kernel.launches, boundary_fuse_kernel.launches
    tr.train_epoch(batches_per_client=BATCHES, backend="vectorized")
    groups = {}
    for cid, ex in tr.split_execs.items():
        groups.setdefault(ex.signature, []).append(
            (BATCHES if cid != "c0" else 1, ex.num_boundaries))
    want_fuse = sum(4 * max(s for s, _ in g) * g[0][1]
                    for g in groups.values())
    assert (dp_clip_noise_kernel.launches - d0,
            boundary_fuse_kernel.launches - b0) == (
        3 * BATCHES - 1, want_fuse)


@pytest.mark.gpu
def test_vectorized_dp_split_step_launches_one_row_kernel_a_crossing(
        parts3, cuda_fp32):
    """The per-example staged step over the client axis on the card: one
    ``amax="row"`` boundary_fuse launch a crossing for the whole signature
    group (4 crossings a boundary), held against each client's loop
    oracle at the Queue C tolerances."""
    from repro_torch.kernels.boundary_fuse.kernel import boundary_fuse_kernel
    tr = _gpu_trainer(parts3, {"split.enabled": True,
                               "split.boundary_stage": "int8+dp",
                               "split.stage_sigma": 0.5,
                               "split.use_kernel": True}, cuda_fp32)
    ex = tr.split_execs["c0"]
    params, real, fake, ks = _client_batches(tr, b=6)
    params = [tree_map(lambda p: p.to(cuda_fp32), p) for p in params]
    real, fake = real.to(cuda_fp32), fake.to(cuda_fp32)
    before = boundary_fuse_kernel.launches
    losses, grads = ex.clients_per_example_value_and_grad(
        stack_trees(params), real, fake, ks)
    assert boundary_fuse_kernel.launches - before == 4 * ex.num_boundaries
    for c, (p, key) in enumerate(zip(params, ks)):
        ol, og = ex.per_example_oracle(p, real[c], fake[c], key)
        np.testing.assert_allclose(losses[c].cpu().numpy(),
                                   ol.cpu().numpy(), rtol=1e-3)
        top = max(float(w.abs().max()) for w in leaves(og))
        for path, a, w in zip(_paths(og), leaves(grads), leaves(og)):
            scale = top if path in DEAD_BIASES else float(w.abs().max())
            np.testing.assert_allclose(a[c].cpu().numpy(), w.cpu().numpy(),
                                       rtol=0, atol=scale / 127,
                                       err_msg=str(path))


@pytest.mark.gpu
def test_trainer_rounds_are_fp32_with_the_global_tf32_flag_on(parts3):
    """The global cuDNN TF32 flag on (PyTorch's default), and the guard
    left to the trainer: a round equals the same round with the flag off,
    bit for bit (deterministic cuDNN algorithms for both), under both
    backends, and the flag reads on again afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    try:
        torch.backends.cudnn.deterministic = True
        for backend in BACKENDS:
            runs = []
            for flag in (True, False):
                torch.backends.cudnn.allow_tf32 = flag
                tr = _gpu_trainer(parts3, {"fed.backend": backend}, dev)
                tr.train_epoch(batches_per_client=BATCHES)
                runs.append(tr)
                assert torch.backends.cudnn.allow_tf32 is flag
            for a, b in zip(leaves(runs[0].state.g_params)
                            + leaves(runs[0].state.d_params["c0"]),
                            leaves(runs[1].state.g_params)
                            + leaves(runs[1].state.d_params["c0"])):
                assert torch.equal(a, b)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def test_rng_untouched_by_probe_helper(parts):
    """The probe's zero batches come from no host RNG: running it alone
    leaves the trainer's stream where it was."""
    tr = _trainer(parts, {})
    tr._ensure_engine(1)
    before = _rng_state(tr)
    backend, probe = tr._resolve_auto_backend(1)
    assert backend in BACKENDS and set(probe) == set(BACKENDS)
    assert _rng_state(tr) == before

