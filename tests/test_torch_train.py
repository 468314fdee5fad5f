"""The port's LM training (``repro_torch.runtime.train``,
``repro_torch.optim.schedule``, ``repro_torch.launch.{train,distributed}``
and real ``remat`` in ``repro_torch.models.transformer``) on the CPU at
smoke size.

Against the JAX package (parameters from the JAX ``lm_init``, carried
across with ``repro_torch.bridge``; the same numpy batches; the JAX side
under ``jax.jit``):

  * ``make_schedule`` for the three schedules over steps 0-120;
  * ``value_and_grad`` of ``lm_loss`` at fp32 on six archs;
  * two steps of ``make_train_step`` with SGD and with AdamW, and one
    bf16 run at qwen3-14b's own dtypes;
  * the FSL step against the reference's vmapped step.

Twins of the reference's runtime invariants (``tests/test_runtime.py``,
``tests/test_system.py``), and inside the port: the three ``remat``
policies equal bit for bit, with fewer bytes saved for the backward under
``"full"``; an FSL client's slice equal to a lone step bit for bit; the
kernels refused for training; the distributed helpers; the launcher.
"""
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro.config import reduce_for_smoke as jreduce_for_smoke
from repro.configs.registry import get_config as jget_config
from repro.models import transformer as JT
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim.schedule import make_schedule as jmake_schedule
from repro.runtime import make_fsl_train_step as jmake_fsl_train_step
from repro.runtime import make_train_step as jmake_train_step
from _torch_config import reference_dict
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic_lm_batch
from repro_torch.launch import distributed as D
from repro_torch.launch import train as LT
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.runtime import make_fsl_train_step, make_train_step
from repro_torch.tree import leaves, tree_map, value_and_grad

CPU = torch.device("cpu")
SEQ, BATCH = 16, 2
# the hybrid at 4 layers: a whole (rglru, rglru, attn) period and a tail
OVER = {"recurrentgemma-9b": {"model.num_layers": 4}}
GRAD_ARCHS = ["rwkv6-1.6b", "qwen3-14b", "olmoe-1b-7b",
              "deepseek-v2-lite-16b", "recurrentgemma-9b", "whisper-base"]
GRAD_TOL = 1e-5
# rwkv6's fp32 gradient is ill-conditioned at this size (its per-head
# norm divides small WKV outputs): against a float64 evaluation of the
# same function, the reference's own fp32 gradient is 2.7e-5 of a leaf's
# largest off and the port's 2.3e-5, so the two are held to 1e-4
GRAD_TOL_ARCH = {"rwkv6-1.6b": 1e-4}
# a key bias adds the same q.b to every score of a query, which softmax
# cancels: its analytic gradient is 0, and both packages give rounding
# noise (~1e-9); such leaves are held against the whole tree's scale
ZERO_GRAD_LEAVES = ("['wk']['b']",)


def _configs(arch, seq=SEQ, batch=BATCH, over=None):
    over = {**OVER.get(arch, {}), **(over or {})}
    jcfg = jreduce_for_smoke(jget_config(arch, "train_4k"), seq_len=seq,
                             batch=batch)
    cfg = reduce_for_smoke(get_config(arch, "train_4k"), seq_len=seq,
                           batch=batch)
    if over:
        jcfg, cfg = jcfg.override(over), cfg.override(over)
    assert reference_dict(cfg) == jcfg.to_dict()
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype="float32", seq=SEQ):
    jcfg, _ = _configs(arch, seq)
    return jax.tree.map(np.asarray, JT.lm_init(jax.random.PRNGKey(0),
                                               jcfg.model, jnp.dtype(dtype)))


def _batch(m, b=BATCH, seq=SEQ, seed=0):
    """The same numpy batch for both packages: tokens, labels with a few
    ignored positions, and whisper's frame embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, m.vocab_size, (b, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :3] = -1
    out = {"tokens": toks, "labels": labels}
    if m.encdec.enabled:
        out["enc_embeds"] = (0.1 * rng.standard_normal(
            (b, m.encdec.encoder_seq, m.d_model))).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _leaf_names(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["constant", "linear", "cosine"])
def test_schedule_matches_jax(name):
    """Steps 0-120 through warmup, decay and past the end, in float32: the
    same value to 1 ulp.  Where the cosine branch's two ``cos`` differ by
    their 1-ulp rounding, ``1 + cos`` carries that into the lr, so the
    cosine is held to 1 ulp of the lr plus the propagated ulp of the cos."""
    for base, warm, total in ((3e-4, 10, 100), (6e-4, 0, 120),
                              (1e-3, 100, 5000)):
        want = jmake_schedule(name, base, warm, total)
        got = make_schedule(name, base, warm, total)
        for step in range(121):
            w = np.float32(want(step))
            g = got(step)
            assert g.dtype == torch.float32 and g.dim() == 0
            g = np.float32(g.item())
            tol = np.spacing(w)
            if name == "cosine":
                tol += np.float32(base * 0.45) * np.spacing(np.float32(1.0))
            assert abs(g - w) <= tol, (name, base, warm, total, step, g, w)


def test_schedule_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule("step", 1e-3)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    jcfg, _ = _configs(arch)
    jm = jcfg.model
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, b, jm, remat="full"), has_aux=True))
    jb, _ = _both(_batch(jm))
    (loss, met), grads = fn(_jax_params(arch), jb)
    return float(loss), float(met["aux_loss"]), grads


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_lm_loss_value_and_grad_matches_jax(arch):
    """fp32, ``remat="full"`` on both sides: loss to rel 1e-5, each
    gradient leaf to 1e-5 of its largest element (rwkv6: see
    ``GRAD_TOL_ARCH``; key biases: see ``ZERO_GRAD_LEAVES``)."""
    _, cfg = _configs(arch)
    m = cfg.model
    jloss, jaux, jgrads = _jax_value_and_grad(arch)
    _, tb = _both(_batch(m))
    params = params_from_numpy(_jax_params(arch), CPU)
    aux = {}

    def loss_fn(p, b):
        total, met = T.lm_loss(p, b, m, None, "full")
        aux["aux"] = float(met["aux_loss"].detach())
        return total

    loss, grads = value_and_grad(loss_fn)(params, tb)
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert aux["aux"] == pytest.approx(jaux, rel=1e-5, abs=1e-7)
    want = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    scale = max(float(np.abs(w).max()) for w in want)
    tol = GRAD_TOL_ARCH.get(arch, GRAD_TOL)
    for name, g, w in zip(_leaf_names(jgrads), leaves(grads), want):
        assert g.shape == w.shape, name
        ref = scale if name.endswith(ZERO_GRAD_LEAVES) else \
            float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol * ref, (arch, name, err, ref)


def _opt_over(name):
    if name == "sgd":
        return {"optim.name": "sgd", "optim.lr": 0.1}
    return {"optim.name": "adamw", "optim.lr": 1e-3,
            "optim.weight_decay": 0.1}


def _run_both_steps(arch, over, steps=2, dtype="float32", b=4):
    """``steps`` of the JAX ``make_train_step`` (jitted) and the port's
    from the same parameters and batches.  -> (jax params, port params,
    jax losses, port losses, lr, jax opt state, port opt state)."""
    over = {"optim.schedule": "cosine", "optim.warmup_steps": 1,
            "optim.total_steps": 4, "parallel.microbatches": 2, **over}
    jcfg, cfg = _configs(arch, batch=b, over=over)
    jparams = _jax_params(arch, dtype)
    jp = jax.tree.map(jnp.asarray, jparams)
    tp = params_from_numpy(jparams, CPU)
    jopt = jmake_optimizer(jcfg.optim)
    jo, to = jopt.init(jp), make_optimizer(cfg.optim).init(tp)
    jstep, tstep = jax.jit(jmake_train_step(jcfg)), make_train_step(cfg)
    jl, tl = [], []
    for i in range(steps):
        jb, tb = _both(_batch(cfg.model, b=b, seed=i))
        jp, jo, jm = jstep(jp, jo, jb, jnp.asarray(i, jnp.int32))
        tp, to, tm = tstep(tp, to, tb, i)
        assert float(tm["lr"]) == float(jm["lr"])
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return jp, tp, jl, tl, float(jcfg.optim.lr), jo, to


def test_train_step_sgd_matches_jax():
    """Two steps, 2 micro-batches, SGD with momentum and the global-norm
    clip: every parameter to 1e-5, and the momentum (the clipped
    gradients' running sum) too."""
    jp, tp, jl, tl, _, jo, to = _run_both_steps("qwen3-14b",
                                                _opt_over("sgd"))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    for a, b in zip(leaves(to["mom"]), jax.tree.leaves(jo["mom"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    moved = max(float((a - torch.as_tensor(np.array(b))).abs().max())
                for a, b in zip(leaves(tp), jax.tree.leaves(
                    _jax_params("qwen3-14b"))))
    assert moved > 1e-3


def test_train_step_adamw_matches_jax():
    """Two AdamW steps (weight decay 0.1): the repo's Adam rule — at most 1
    element in 10,000 of a leaf beyond 1e-5 (Adam turns rounding-level
    gradients into ~lr steps), all within 2 x lr x steps."""
    jp, tp, jl, tl, lr, _, _ = _run_both_steps("recurrentgemma-9b",
                                               _opt_over("adamw"))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        d = np.abs(a.numpy() - np.asarray(b))
        assert (d > 1e-5).sum() <= max(1, d.size // 10_000), d.max()
        assert d.max() <= 2 * lr * 2


def test_train_step_bf16_matches_jax():
    """qwen3-14b's own dtypes (bf16 parameters, AdamW state and compute):
    the two steps' losses within 2e-2."""
    _, _, jl, tl, _, _, _ = _run_both_steps(
        "qwen3-14b", {"parallel.param_dtype": "bfloat16",
                      "parallel.compute_dtype": "bfloat16"},
        dtype="bfloat16")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-2)


def test_fsl_step_matches_jax():
    """3 clients, ``local_steps`` 2, SGD, 2 steps (a local step, then the
    FedAvg round): every replica's parameters to 1e-5 of the reference's
    vmapped step, and the client-mean metrics."""
    n = 3
    over = {"fsl.local_steps": 2, "optim.schedule": "constant",
            "optim.warmup_steps": 0, **_opt_over("sgd")}
    jcfg, cfg = _configs("qwen3-14b", over=over)
    jparams = _jax_params("qwen3-14b")
    jp = jax.tree.map(lambda x: jnp.broadcast_to(jnp.asarray(x)[None],
                                                 (n, *x.shape)), jparams)
    jopt = jmake_optimizer(jcfg.optim).init(
        jax.tree.map(jnp.asarray, jparams))
    jo = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (n, *x.shape)),
                      jopt)
    tp = tree_map(lambda x: x[None].expand(n, *x.shape),
                  params_from_numpy(jparams, CPU))
    to = tree_map(lambda x: x[None].expand(n, *x.shape),
                  make_optimizer(cfg.optim).init(
                      params_from_numpy(jparams, CPU)))
    jstep = jax.jit(jmake_fsl_train_step(jcfg, n))
    tstep = make_fsl_train_step(cfg, n)
    for i in range(2):
        b = _batch(cfg.model, b=n * BATCH, seed=10 + i)
        b = {k: v.reshape(n, BATCH, *v.shape[1:]) for k, v in b.items()}
        jb, tb = _both(b)
        jp, jo, jm = jstep(jp, jo, jb, jnp.asarray(i, jnp.int32))
        tp, to, tm = tstep(tp, to, tb, i)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        for a, w in zip(leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# twins of the reference's runtime invariants
# ---------------------------------------------------------------------------

def _setup(arch="qwen3-14b", seq=32, batch=8, **over):
    cfg = reduce_for_smoke(get_config(arch, "train_4k"), seq_len=seq,
                           batch=batch)
    over.setdefault("optim.warmup_steps", 0)
    over.setdefault("optim.schedule", "constant")
    cfg = cfg.override(over)
    m = cfg.model
    params = T.lm_init(0, m, device=CPU)
    return cfg, m, params, make_optimizer(cfg.optim).init(params)


def _tbatch(n, seq, vocab, seed):
    return {k: torch.as_tensor(v) for k, v in
            synthetic_lm_batch(n, seq, vocab, seed=seed).items()}


def test_train_step_reduces_loss():
    """Twin of ``tests/test_runtime.py:27``."""
    cfg, m, params, opt_state = _setup(batch=8)
    step = make_train_step(cfg)
    batch = _tbatch(8, 32, m.vocab_size, 0)
    losses = []
    for i in range(30):
        params, opt_state, metrics = step(params, opt_state, batch, i)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]


def test_microbatch_count_invariance():
    """Twin of ``tests/test_runtime.py:40``: nmb=1 vs nmb=4 on the same
    data give (nearly) identical updates."""
    batch = _tbatch(8, 32, 256, 1)
    outs = {}
    for nmb in (1, 4):
        cfg, m, params, opt_state = _setup(
            batch=8, **{"parallel.microbatches": nmb,
                        "model.vocab_size": 256})
        p2, _, metrics = make_train_step(cfg)(params, opt_state, batch, 0)
        outs[nmb] = (p2, float(metrics["loss"]))
    assert outs[1][1] == pytest.approx(outs[4][1], rel=1e-4)
    for a, b in zip(leaves(outs[1][0]), leaves(outs[4][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)


def _replicate(tree, n):
    return tree_map(lambda x: x[None].expand(n, *x.shape), tree)


def _cbatch(n, m, seed, b=4):
    return {k: v.reshape(n, b, -1)
            for k, v in _tbatch(b * n, 32, m.vocab_size, seed).items()}


def _spread(tree):
    return max(float((l - l[0:1]).abs().max()) for l in leaves(tree))


def test_fsl_step_averages_on_cadence():
    """Twin of ``tests/test_runtime.py:59``: with local_steps=2 the
    replicas diverge after step 0 and are equal (here bit for bit) after
    step 1, the FedAvg round; the optimizer state is not averaged."""
    n = 3
    cfg, m, params, opt_state = _setup(batch=4, **{"fsl.local_steps": 2})
    step = make_fsl_train_step(cfg, n)
    cp, co = _replicate(params, n), _replicate(opt_state, n)
    cp, co, _ = step(cp, co, _cbatch(n, m, 0), 0)
    assert _spread(cp) > 0, "clients should diverge on local step"
    cp, co, _ = step(cp, co, _cbatch(n, m, 1), 1)
    assert _spread(cp) == 0, "FedAvg round should equalize replicas"
    assert _spread(co["m"]) > 0


def test_fsl_every_step_equals_sync():
    """Twin of ``tests/test_runtime.py:88``: local_steps=1 keeps the
    replicas identical at every step."""
    n = 2
    cfg, m, params, opt_state = _setup(batch=4, **{"fsl.local_steps": 1})
    step = make_fsl_train_step(cfg, n)
    cp, co, _ = step(_replicate(params, n), _replicate(opt_state, n),
                     _cbatch(n, m, 2), 0)
    for leaf in leaves(cp):
        assert torch.equal(leaf[0], leaf[1])


def test_lm_trains_on_synthetic_structure():
    """Twin of ``tests/test_system.py:17``: the synthetic token stream is
    learnable, rwkv6-1.6b's loss drops by more than 1 in 40 steps."""
    cfg, m, params, opt_state = _setup("rwkv6-1.6b", **{"optim.lr": 3e-3})
    step = make_train_step(cfg)
    losses = []
    for i in range(40):
        params, opt_state, metrics = step(
            params, opt_state, _tbatch(8, 32, m.vocab_size, i % 4), i)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

def _saved_bytes(fn):
    """Bytes of the tensors autograd saves for the backward while ``fn``
    runs (a checkpointed region saves none: it keeps its inputs and
    recomputes)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b",
                                  "whisper-base", "olmoe-1b-7b"])
def test_remat_policies_equal_bit_for_bit(arch):
    """``remat`` "none", "full" and "dots" give the same loss and gradients
    bit for bit (recurrentgemma: a period and a tail; whisper: the
    encoder's periods too; olmoe: the aux loss); "full" saves fewer bytes
    for the backward than "none"."""
    _, cfg = _configs(arch, seq=8)
    m = cfg.model
    params = T.lm_init(0, m, device=CPU)
    _, batch = _both(_batch(m, seq=8))
    res, saved = {}, {}
    for remat in ("none", "full", "dots"):
        def run():
            return value_and_grad(lambda p, b: T.lm_loss(
                p, b, m, None, remat)[0])(params, batch)
        res[remat], saved[remat] = _saved_bytes(run)
    loss, grads = res["none"]
    for remat in ("full", "dots"):
        assert torch.equal(res[remat][0], loss), remat
        for a, b in zip(leaves(res[remat][1]), leaves(grads)):
            assert torch.equal(a, b), remat
    assert saved["full"] < saved["none"], saved


def test_unknown_remat_raises():
    _, cfg = _configs("qwen3-14b", seq=8)
    m = cfg.model
    params = T.lm_init(0, m, device=CPU)
    _, batch = _both(_batch(m, seq=8))
    with pytest.raises(ValueError, match="unknown remat"):
        value_and_grad(lambda p, b: T.lm_loss(p, b, m, None, "some")[0])(
            params, batch)


def test_fsl_client_slice_equals_lone_step():
    """On a local step each client's slice of the FSL step's result is
    the lone train step on that client's slice, bit for bit."""
    n = 3
    cfg, m, params, opt_state = _setup(batch=4, **{
        "fsl.local_steps": 2, "optim.schedule": "cosine",
        "optim.warmup_steps": 2})
    cp = tree_map(lambda x: x[None].expand(n, *x.shape).clone(), params)
    cp = tree_map(lambda x: x + 1e-3 * torch.arange(n, dtype=x.dtype).view(
        n, *[1] * (x.dim() - 1)), cp)
    co = _replicate(opt_state, n)
    cb = _cbatch(n, m, 5)
    out_p, out_o, met = make_fsl_train_step(cfg, n)(cp, co, cb, 0)
    base = make_train_step(cfg)
    losses = []
    for c in range(n):
        p, o, mt = base(tree_map(lambda x: x[c].clone(), cp),
                        tree_map(lambda x: x[c].clone(), co),
                        tree_map(lambda x: x[c].clone(), cb), 0)
        losses.append(mt["loss"])
        for a, b in zip(leaves(p), leaves(tree_map(lambda x: x[c], out_p))):
            assert torch.equal(a, b)
        for a, b in zip(leaves(o), leaves(tree_map(lambda x: x[c], out_o))):
            assert torch.equal(a, b)
    assert torch.equal(met["loss"], torch.mean(torch.stack(losses)))


def test_flash_kernel_config_refused():
    """The kernels are forward-only: a train step built with them raises
    before any work."""
    cfg, *_ = _setup(batch=4, **{"parallel.use_flash_kernel": True})
    with pytest.raises(ValueError, match="forward-only"):
        make_train_step(cfg)
    with pytest.raises(ValueError, match="forward-only"):
        make_fsl_train_step(cfg, 2)


def test_distributed_without_env_vars(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert D.maybe_initialize_distributed() is False
    assert D.is_primary()
    assert D.log_topology().startswith("process 0/1 ")


def test_distributed_initialises_from_env_vars(monkeypatch):
    """One process (gloo on the CPU) at a local address from the env
    vars."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"localhost:{port}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    try:
        assert D.maybe_initialize_distributed() is True
        assert torch.distributed.get_world_size() == 1
        assert D.is_primary()
        assert D.log_topology().startswith("process 0/1 ")
    finally:
        torch.distributed.destroy_process_group()


def test_train_launcher_cli():
    """``python -m repro_torch.launch.train --arch rwkv6-1.6b --smoke
    --steps 2 --device cpu``."""
    hist = LT.main(["--arch", "rwkv6-1.6b", "--smoke", "--steps", "2",
                    "--smoke-seq", "16", "--device", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(hist))


def test_train_loop_fsl_checkpoints(tmp_path):
    """FSL replicas through ``train_loop`` (whisper: the frame embeddings
    from the launcher's key), checkpointed at step 50 and restored bit for
    bit."""
    cfg = reduce_for_smoke(get_config("whisper-base", "train_4k"),
                           seq_len=4, batch=1).override(
        {"model.encdec.encoder_seq": 4, "model.num_layers": 1,
         "model.encdec.encoder_layers": 1, "fsl.local_steps": 2})
    seen = []
    params, hist = LT.train_loop(
        cfg, 50, fsl_clients=2, ckpt_dir=str(tmp_path), log_every=25,
        device="cpu", on_step=lambda i, p, met, s: seen.append(i))
    assert seen == list(range(50)) and all(np.isfinite(hist))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.steps() == [50]
    back, extra = mgr.restore(like=params)
    assert extra["step"] == 50
    for a, b in zip(leaves(back), leaves(params)):
        assert torch.equal(a, b)
    for leaf in leaves(params):
        assert leaf.shape[0] == 2 and torch.equal(leaf[0], leaf[1])
