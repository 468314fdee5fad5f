"""The port's LM substrate (qwen3-14b: dense attention; rwkv6-1.6b: the
RWKV-6 recurrence) held against the JAX package at smoke size.

Both packages get the JAX ``lm_init`` parameters (carried across with
``repro_torch.bridge``) and the same numpy token batches, at
``reduce_for_smoke(seq_len=16, batch=2)`` in fp32 on the CPU.  The forward
(with and without the kernels: the port's ops take their plain versions on
the CPU, the JAX Pallas kernels run in interpret mode), the loss, and
prefill + decode must match JAX to 1e-4; inside the port, prefill + decode
must reproduce the teacher-forced forward to 5e-4, the reference's own pin
(``tests/test_decode_consistency.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro.config import reduce_for_smoke as jreduce_for_smoke
from repro.configs.registry import SkippedShape as JSkippedShape
from repro.configs.registry import get_config as jget_config
from repro.launch.serve import Request as JRequest
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import transformer as JT
from _torch_config import reference_dict
from repro_torch.bridge import params_from_numpy
from repro_torch.config import INPUT_SHAPES, reduce_for_smoke
from repro_torch.configs.registry import SkippedShape, get_config
from repro_torch.data import synthetic_lm_batch, synthetic_tokens
from repro_torch.launch.serve import Request, serve_batch
from repro_torch.models import transformer as T
from repro_torch.runtime import cache_length, make_decode_step, \
    make_prefill_step

ARCHS = ["qwen3-14b", "rwkv6-1.6b"]
TOL = dict(rtol=0, atol=1e-4)
CPU = torch.device("cpu")


def _setup(arch, seq=16, batch=2, **over):
    jcfg = jreduce_for_smoke(jget_config(arch, "train_4k"), seq_len=seq,
                             batch=batch)
    cfg = reduce_for_smoke(get_config(arch, "train_4k"), seq_len=seq,
                           batch=batch)
    if over:
        jcfg, cfg = jcfg.override(over), cfg.override(over)
    assert reference_dict(cfg) == jcfg.to_dict()
    jparams = jax.tree.map(np.asarray, JT.lm_init(jax.random.PRNGKey(0),
                                                  jcfg.model))
    return jcfg, cfg, jparams, params_from_numpy(jparams, CPU)


def _batch(cfg, seed=0):
    b = synthetic_lm_batch(cfg.shape.global_batch, cfg.shape.seq_len,
                           cfg.model.vocab_size, seed=seed)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(INPUT_SHAPES) + [None])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch, shape):
    assert reference_dict(get_config(arch, shape)) == \
        jget_config(arch, shape).to_dict()


def test_long_500k_binding():
    assert get_config("qwen3-14b", "long_500k").model.attention == "sliding"
    assert get_config("qwen3-14b", "long_500k").model.sliding_window == 4096
    assert get_config("rwkv6-1.6b", "long_500k").model.attention == "none"
    with pytest.raises(KeyError, match="unknown shape"):
        get_config("qwen3-14b", "train_8k")
    with pytest.raises(JSkippedShape):
        jget_config("whisper-base", "long_500k")
    assert issubclass(SkippedShape, Exception)


def test_lm_init_stacks_layers():
    """The period's parameters are stacked on a leading layer axis."""
    m = reduce_for_smoke(get_config("qwen3-14b")).model
    assert T.lm_init(0, m, device="cpu")["stack"]["b0"]["attn"]["wq"][
        "w"].shape == (m.num_layers, m.d_model, m.q_dim)


def test_synthetic_lm_data_is_the_reference_data():
    from repro.data import synthetic_lm_batch as jbatch
    from repro.data import synthetic_tokens as jtokens
    np.testing.assert_array_equal(synthetic_tokens(3, 40, 999, seed=5),
                                  jtokens(3, 40, 999, seed=5))
    got, want = synthetic_lm_batch(2, 9, 77, seed=1), jbatch(2, 9, 77, seed=1)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# parameters: the bf16 bridge and the port's own init
# ---------------------------------------------------------------------------

def test_bf16_tree_crosses_bit_for_bit():
    from repro_torch.bridge import params_to_numpy
    cfg = jreduce_for_smoke(jget_config("qwen3-14b", "train_4k"))
    jparams = jax.tree.map(np.asarray, JT.lm_init(
        jax.random.PRNGKey(1), cfg.model, jnp.bfloat16))
    tparams = params_from_numpy(jparams, CPU)
    back = params_to_numpy(tparams)
    for a, t, c in zip(jax.tree.leaves(jparams), jax.tree.leaves(tparams),
                       jax.tree.leaves(back)):
        assert t.dtype == torch.bfloat16 and t.shape == a.shape
        assert c.dtype == a.dtype
        np.testing.assert_array_equal(c.view(np.uint16), a.view(np.uint16))
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_tree(arch):
    jcfg = jreduce_for_smoke(jget_config(arch))
    want = jax.eval_shape(lambda k: JT.lm_init(k, jcfg.model, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    m = reduce_for_smoke(get_config(arch)).model
    got = T.lm_init(3, m, torch.bfloat16, device="cpu")
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g = jax.tree.leaves(got)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, want))
    for w, g in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
    # a seed gives the same parameters again, another seed others
    again = T.lm_init(3, m, torch.bfloat16, device="cpu")
    other = T.lm_init(4, m, torch.bfloat16, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(flat_g,
                                                 jax.tree.leaves(again)))
    assert not torch.equal(got["embed"]["table"], other["embed"]["table"])


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = reduce_for_smoke(get_config("rwkv6-1.6b")).model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.lm_init(0, m)
    cfg = reduce_for_smoke(get_config("rwkv6-1.6b", "decode_32k"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_batch(cfg, [Request(0, np.arange(4, dtype=np.int32))], 2,
                    verbose=False)


# ---------------------------------------------------------------------------
# forward and loss vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_apply_and_loss_match_jax(arch, use_kernel):
    jcfg, cfg, jparams, tparams = _setup(arch)
    jb, tb = _batch(cfg)
    jlogits, jaux = JT.lm_apply(jparams, jb, jcfg.model, remat="none",
                                use_kernel=use_kernel)
    logits, aux = T.lm_apply(tparams, tb, cfg.model, use_kernel=use_kernel)
    assert logits.dtype == torch.float32
    _close(logits, jlogits)
    _close(aux, jaux)
    jloss, jm = JT.lm_loss(jparams, jb, jcfg.model, remat="none",
                           use_kernel=use_kernel)
    loss, met = T.lm_loss(tparams, tb, cfg.model, use_kernel=use_kernel)
    _close(loss, jloss)
    for k in ("loss", "aux_loss", "tokens"):
        _close(met[k], jm[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_path_equals_plain_path_in_the_port(arch):
    _, cfg, _, tparams = _setup(arch)
    _, tb = _batch(cfg, seed=3)
    tb["labels"][0, :5] = -1                 # ignored positions
    a, _ = T.lm_apply(tparams, tb, cfg.model, use_kernel=False)
    b, _ = T.lm_apply(tparams, tb, cfg.model, use_kernel=True)
    _close(a, b.numpy())
    la, _ = T.lm_loss(tparams, tb, cfg.model, use_kernel=False)
    lb, mb = T.lm_loss(tparams, tb, cfg.model, use_kernel=True)
    _close(la, lb.numpy())
    assert float(mb["tokens"]) == tb["labels"].numel() - 5
    with pytest.raises(RuntimeError, match="forward-only"):
        with torch.enable_grad():
            T.lm_loss({k: v for k, v in tparams.items()} | {
                "embed": {"table": tparams["embed"]["table"].clone()
                          .requires_grad_(True)}}, tb, cfg.model,
                use_kernel=True)


# ---------------------------------------------------------------------------
# prefill + decode
# ---------------------------------------------------------------------------

def _prefill_decode(run_prefill, run_decode, toks, pre_len, seq):
    lg, state, idx = run_prefill(toks[:, :pre_len])
    out = [lg]
    for t in range(pre_len, seq):
        lg, state = run_decode(toks[:, t], state, t)
        out.append(lg)
    return out


@pytest.mark.parametrize("arch,over", [
    ("qwen3-14b", {}), ("rwkv6-1.6b", {}),
    ("qwen3-14b", {"model.attention": "sliding",
                   "model.sliding_window": 5})], ids=["qwen3", "rwkv6",
                                                       "qwen3_ring"])
def test_prefill_decode_matches_jax_and_forward(arch, over):
    seq = 24 if over else 12
    pre_len = 6 if over else 8
    jcfg, cfg, jparams, tparams = _setup(arch, seq=seq, **over)
    toks = np.random.default_rng(1).integers(
        0, cfg.model.vocab_size, (2, seq)).astype(np.int32)
    jm, m = jcfg.model, cfg.model
    want = _prefill_decode(
        lambda tk: JT.lm_prefill(jparams, {"tokens": jnp.asarray(tk)}, jm,
                                 cache_len=seq, cache_dtype=jnp.float32),
        lambda tk, st, t: JT.lm_decode_step(jparams, jnp.asarray(tk), st,
                                            jnp.asarray(t, jnp.int32), jm),
        toks, pre_len, seq)
    got = _prefill_decode(
        lambda tk: T.lm_prefill(tparams, {"tokens": torch.as_tensor(tk)}, m,
                                cache_len=seq, cache_dtype=torch.float32),
        lambda tk, st, t: T.lm_decode_step(tparams, torch.as_tensor(tk), st,
                                           t, m),
        toks, pre_len, seq)
    full, _ = T.lm_apply(tparams, {"tokens": torch.as_tensor(toks)}, m)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w)
        _close(g, full[:, pre_len - 1 + i].numpy(), dict(rtol=0, atol=5e-4))


def test_decode_state_layout_matches_jax():
    for arch in ARCHS:
        jcfg, cfg, _, _ = _setup(arch)
        want = JT.init_decode_state(jcfg.model, 2, 9, jnp.float32)
        got = T.init_decode_state(cfg.model, 2, 9, torch.float32,
                                  device="cpu")
        assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
            jax.tree.structure(jax.tree.map(lambda _: 0, got))
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert tuple(g.shape) == w.shape and not g.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_matches_jax(arch):
    jcfg = jreduce_for_smoke(jget_config(arch, "decode_32k"), seq_len=64,
                             batch=3)
    cfg = reduce_for_smoke(get_config(arch, "decode_32k"), seq_len=64,
                           batch=3)
    rng = np.random.default_rng(0)
    lens = [int(rng.integers(8, 17)) for _ in range(3)]
    prompts = [synthetic_tokens(1, n, cfg.model.vocab_size, seed=i)[0]
               for i, n in enumerate(lens)]
    want = jserve_batch(jcfg, [JRequest(i, p) for i, p in enumerate(prompts)],
                        6, seed=0, verbose=False)
    params = params_from_numpy(jax.tree.map(np.asarray, JT.lm_init(
        jax.random.PRNGKey(0), jcfg.model)), CPU)
    got = serve_batch(cfg, [Request(i, p) for i, p in enumerate(prompts)], 6,
                      verbose=False, device="cpu", params=params)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert cache_length(cfg) == cfg.shape.seq_len
    assert callable(make_prefill_step(cfg)) and callable(
        make_decode_step(cfg))
