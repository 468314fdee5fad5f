"""The port's eight further LM architectures (MoE, MLA, RG-LRU hybrid,
whisper encoder-decoder, VLM and the dense granite / qwen2 / llama3) held
against the JAX package at smoke size, fp32, on the CPU.

Each arch runs at ``reduce_for_smoke(seq_len=12, batch=2)``;
recurrentgemma-9b at 4 layers, so its stack holds one whole
(rglru, rglru, attn) period and a recurrent tail.  Both packages get the
JAX ``lm_init`` parameters (carried across with ``repro_torch.bridge``)
and the same numpy tokens; whisper's batches carry the same numpy frame
embeddings (``enc_embeds``).  The JAX side runs under ``jax.jit``, one
compile a function an arch, shared by the tests.  Held:

  * the configs, the parameter tree and the decode-state layout;
  * ``lm_loss`` (loss and aux) and its logits, through the flash op (its
    plain version on the CPU) and on the plain path, to 1e-4;
  * prefill + decode logits to JAX's (1e-4) and to the teacher-forced
    forward (5e-4, the reference's pin), also on a 5-slot ring;
  * ``serve_batch``'s greedy tokens over 4 steps equal to JAX's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro.config import reduce_for_smoke as jreduce_for_smoke
from repro.configs.registry import SkippedShape as JSkippedShape
from repro.configs.registry import get_config as jget_config
from repro.models import frontends as JF
from repro.models import transformer as JT
from _torch_config import reference_dict
from repro_torch.bridge import params_from_numpy
from repro_torch.config import INPUT_SHAPES, reduce_for_smoke
from repro_torch.configs.registry import SkippedShape, get_config, list_archs
from repro_torch.launch.serve import Request, serve_batch
from repro_torch.models import frontends as F
from repro_torch.models import transformer as T

ARCHS = ["olmoe-1b-7b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
         "whisper-base", "chameleon-34b", "granite-20b", "qwen2-72b",
         "llama3-405b"]
# the hybrid at 4 layers: a whole (rglru, rglru, attn) period and a tail
OVER = {"recurrentgemma-9b": {"model.num_layers": 4}}
SEQ, PRE, GEN = 12, 8, 4
TOL = dict(rtol=0, atol=1e-4)
DECODE_PIN = dict(rtol=0, atol=5e-4)
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _setup(arch, ring=False):
    """-> (jm, m, jparams, tparams, jitted JAX (loss, prefill, decode)),
    once an arch."""
    over = dict(OVER.get(arch, {}))
    seq = SEQ
    if ring:
        over.update({"model.attention": "sliding",
                     "model.sliding_window": 5, "model.num_layers": 3})
        seq = 24
    jcfg = jreduce_for_smoke(jget_config(arch, "train_4k"), seq_len=seq,
                             batch=2)
    cfg = reduce_for_smoke(get_config(arch, "train_4k"), seq_len=seq,
                           batch=2)
    if over:
        jcfg, cfg = jcfg.override(over), cfg.override(over)
    assert reference_dict(cfg) == jcfg.to_dict()
    jm, m = jcfg.model, cfg.model
    jparams = jax.tree.map(np.asarray, JT.lm_init(jax.random.PRNGKey(0), jm))
    fns = (jax.jit(lambda p, b: JT.lm_loss(p, b, jm, remat="none")),
           jax.jit(lambda p, b: JT.lm_prefill(p, b, jm, cache_len=seq,
                                              cache_dtype=jnp.float32)),
           jax.jit(lambda p, tk, st, t: JT.lm_decode_step(p, tk, st, t, jm)),
           jax.jit(lambda p, b: JT.lm_apply(p, b, jm, remat="none")))
    return jm, m, jparams, params_from_numpy(jparams, CPU), fns


def _batch(m, seq, seed=0):
    """The same numpy batch for both packages: tokens, labels with a few
    ignored positions, and whisper's frame embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, m.vocab_size, (2, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :3] = -1
    b = {"tokens": toks, "labels": labels}
    if m.encdec.enabled:
        b["enc_embeds"] = (0.1 * rng.standard_normal(
            (2, m.encdec.encoder_seq, m.d_model))).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# configs, parameters, state
# ---------------------------------------------------------------------------

def test_registry_lists_every_reference_arch():
    from repro.configs.registry import list_archs as jlist_archs
    assert list_archs() == jlist_archs()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("shape", list(INPUT_SHAPES) + [None])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch, shape):
    try:
        want = jget_config(arch, shape).to_dict()
    except JSkippedShape:
        with pytest.raises(SkippedShape, match="448"):
            get_config(arch, shape)
        return
    assert reference_dict(get_config(arch, shape)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_tree(arch):
    jcfg = jreduce_for_smoke(jget_config(arch)).override(OVER.get(arch, {}))
    want = jax.eval_shape(lambda k: JT.lm_init(k, jcfg.model, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    m = reduce_for_smoke(get_config(arch)).override(OVER.get(arch, {})).model
    got = T.lm_init(3, m, torch.bfloat16, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, want))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
    again = T.lm_init(3, m, torch.bfloat16, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(got),
                                                 jax.tree.leaves(again)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_layout_matches_jax(arch):
    jm, m, _, _, _ = _setup(arch)
    want = JT.init_decode_state(jm, 2, 9, jnp.float32)
    got = T.init_decode_state(m, 2, 9, torch.float32, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, got))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape and not g.any()


# ---------------------------------------------------------------------------
# forward and loss vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch):
    """The flash op's path (the ``attn`` and ``moe`` layers' attention;
    its plain version on the CPU) and the plain path, against JAX's plain
    forward."""
    jm, m, jp, tp, (jloss, _, _, japply) = _setup(arch)
    jb, tb = _batch(m, SEQ)
    jl, jmet = jloss(jp, jb)
    jlogits, _ = japply(jp, jb)
    for use_kernel in (True, False):
        with torch.no_grad():
            loss, met = T.lm_loss(tp, tb, m, use_kernel=use_kernel)
            logits, aux = T.lm_apply(tp, tb, m, use_kernel=use_kernel)
        _close(loss, jl)
        _close(logits, jlogits)
        for k in ("loss", "aux_loss", "tokens"):
            _close(met[k], jmet[k])
    assert float(met["tokens"]) == 2 * SEQ - 3
    if m.moe.enabled:
        assert float(met["aux_loss"]) > 0


def _prefill_decode(prefill, decode, toks, pre_len, seq):
    lg, state, _ = prefill(toks[:, :pre_len])
    out = [lg]
    for t in range(pre_len, seq):
        lg, state = decode(toks[:, t], state, t)
        out.append(lg)
    return out


@pytest.mark.parametrize("arch,ring", [(a, False) for a in ARCHS]
                         + [("recurrentgemma-9b", True)],
                         ids=ARCHS + ["recurrentgemma-9b-ring"])
def test_prefill_decode_matches_jax_and_forward(arch, ring):
    """Prefill 8 (6 on the ring) positions, decode the rest; the ring
    case's attention cache is 5 slots over 24 positions."""
    jm, m, jp, tp, (_, jprefill, jdecode, _) = _setup(arch, ring)
    seq, pre = (24, 6) if ring else (SEQ, PRE)
    jb, tb = _batch(m, seq, seed=1)
    toks = tb["tokens"].numpy()
    extra = {k: v for k, v in tb.items() if k == "enc_embeds"}
    jextra = {k: v for k, v in jb.items() if k == "enc_embeds"}
    want = _prefill_decode(
        lambda tk: jprefill(jp, dict(jextra, tokens=jnp.asarray(tk))),
        lambda tk, st, t: jdecode(jp, jnp.asarray(tk), st,
                                  jnp.asarray(t, jnp.int32)),
        toks, pre, seq)
    with torch.no_grad():
        got = _prefill_decode(
            lambda tk: T.lm_prefill(tp, dict(extra, tokens=torch.as_tensor(
                tk)), m, cache_len=seq, cache_dtype=torch.float32),
            lambda tk, st, t: T.lm_decode_step(tp, torch.as_tensor(tk), st,
                                               t, m),
            toks, pre, seq)
        full, _ = T.lm_apply(tp, dict(extra, tokens=tb["tokens"]), m)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w)
        _close(g, full[:, pre - 1 + i].numpy(), DECODE_PIN)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_match_jax(arch):
    """``serve_batch`` over 2 left-padded requests (5 and 8 prompt
    tokens), 4 greedy tokens, against JAX's prefill and decode run the
    way the reference's ``serve_batch`` runs them; whisper's frame
    embeddings injected into both."""
    jm, m, jp, tp, (_, jprefill, jdecode, _) = _setup(arch)
    cfg = reduce_for_smoke(get_config(arch, "decode_32k"), seq_len=SEQ,
                           batch=2).override(OVER.get(arch, {}))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, m.vocab_size, n).astype(np.int32)
               for n in (5, PRE)]
    padded = np.zeros((2, PRE), np.int32)
    for i, p in enumerate(prompts):
        padded[i, PRE - len(p):] = p
    enc = None
    jb = {"tokens": jnp.asarray(padded)}
    if m.encdec.enabled:
        e = (0.1 * rng.standard_normal((2, m.encdec.encoder_seq, m.d_model))
             ).astype(np.float32)
        jb["enc_embeds"], enc = jnp.asarray(e), torch.as_tensor(e)
    logits, state, index = jprefill(jp, jb)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want = [[], []]
    for step in range(GEN):
        for i in range(2):
            want[i].append(int(tok[i]))
        logits, state = jdecode(jp, tok, state,
                                jnp.asarray(PRE + step, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    got = serve_batch(cfg, [Request(i, p) for i, p in enumerate(prompts)],
                      GEN, verbose=False, device="cpu", params=tp,
                      enc_embeds=enc)
    assert [r.generated for r in got] == want


# ---------------------------------------------------------------------------
# the stub frontends
# ---------------------------------------------------------------------------

def test_frontends_have_the_reference_shapes_and_ranges():
    m = get_config("chameleon-34b").model
    gen = torch.Generator().manual_seed(0)
    toks, mask = F.vlm_interleave(gen, 3, 600, m)
    jtoks, jmask = JF.vlm_interleave(jax.random.PRNGKey(0), 3, 600, m)
    assert toks.shape == jtoks.shape and toks.dtype == torch.int32
    assert mask.shape == jmask.shape and mask.dtype == torch.bool
    text_hi = int(m.vocab_size * 0.75)
    assert (mask.sum(1) == 256).all()          # one 256-token image span
    assert (toks[mask] >= text_hi).all() and (toks[mask] < m.vocab_size).all()
    assert (toks[~mask] >= 0).all() and (toks[~mask] < text_hi).all()
    again, _ = F.vlm_interleave(torch.Generator().manual_seed(0), 3, 600, m)
    assert torch.equal(toks, again)
    short, smask = F.vlm_interleave(gen, 2, 10, m)  # span <= seq // 2
    assert (smask.sum(1) == 5).all()

    w = get_config("whisper-base").model
    e = F.audio_frame_embeddings(torch.Generator().manual_seed(0), 2, w)
    je = JF.audio_frame_embeddings(jax.random.PRNGKey(0), 2, w)
    assert e.shape == je.shape == (2, 1500, 512) and e.dtype == torch.float32
    assert abs(float(e.std()) - 0.1) < 2e-3


def test_serve_draws_whisper_frames_from_its_seed():
    """Without ``enc_embeds``, a whisper batch's frames come from the
    serve's seed: the same seed serves the same tokens."""
    cfg = reduce_for_smoke(get_config("whisper-base", "decode_32k"),
                           seq_len=16, batch=2)
    prompt = np.arange(1, 7, dtype=np.int32)

    def run(seed):
        return serve_batch(cfg, [Request(0, prompt), Request(1, prompt[:3])],
                           3, seed=seed, verbose=False, device="cpu")

    assert [r.generated for r in run(1)] == [r.generated for r in run(1)]
