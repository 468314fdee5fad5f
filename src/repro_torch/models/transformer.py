"""Language-model assembly: embeddings -> period-stacked block stack -> head
(port of ``repro/models/transformer.py``).

Every family of the reference: decoder-only (dense / moe / ssm / hybrid /
vlm) and encoder-decoder (whisper).  Layers are stacked per *period* as in
the reference; the stack runs as a Python loop over periods (the
reference's ``lax.scan`` and its unrolled loop compute the same values, so
``scan_layers`` is accepted and changes nothing).  Leading dense layers
(``first_dense_layers``, a setting the reference lacks) sit under
``lead`` as ``l0``, ``l1``, ... and run before the stack, each under
``remat`` as a period; their decode state is under ``lead`` too, and a
model without them has neither.  ``remat`` is the
reference's: where autograd records the forward, ``"full"`` checkpoints
each period (``jax.checkpoint(period_fn)``: only the period's input is
kept, the rest recomputed in the backward) and ``"dots"`` keeps the
outputs of the period's un-batched matrix products and recomputes the
rest (``checkpoint_dots_with_no_batch_dims``); ``"none"`` keeps every
residual.  All three give the same values; prefill and decode run no
checkpoint.

Public API
----------
  lm_init(seed, m, dtype, device)          random params from a seed
  lm_param_shapes(m, dtype)                ShapeDtype tree (nothing allocated)
  lm_specs(m)                              logical-axis tree (matches params)
  lm_apply(params, batch, m, ...)          -> (logits, aux_loss)
  lm_loss(params, batch, m, ...)           -> (loss, metrics)
  init_decode_state(m, batch, cache_len)   stacked decode state
  decode_state_shapes(m, batch, cache_len) its ShapeDtype tree
  decode_state_specs(m)                    logical-axis tree for the state
  lm_prefill(params, batch, m, ...)        -> (logits_last, state, index)
  lm_decode_step(params, token, state, index, m, ...) -> (logits, state)

The shape functions run the init under ``FakeTensorMode`` on a fake CPU
device: every leaf's shape and dtype, with no storage behind it, so even
llama3-405b's 811.7 GB of parameters allocate nothing.

Tensors in ``batch`` live on the parameters' device; an encoder-decoder
batch also carries ``enc_embeds`` (B, S_enc, d), the stub frontend's frame
embeddings.  Decode updates the state it is given in place and returns it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import HYBRID, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.blocks import (block_apply, block_decode, block_init,
                                       block_specs, block_state_init,
                                       block_state_specs, lead_kinds,
                                       norm_apply, norm_init, norm_specs,
                                       period_of, split_periods)
from repro_torch.sharding.specs import Lg, constrain
from repro_torch.tree import shapes_of, tree_map

REMATS = ("none", "full", "dots")


# ---------------------------------------------------------------------------
# init / specs / shapes
# ---------------------------------------------------------------------------

def _stack_init(gen, m: ModelConfig, dtype):
    """Period parameters stacked on a leading axis, drawn one period at a
    time straight into the stacked buffers (a full-width fp32 stack of one
    MLP leaf would not fit beside the bf16 model)."""
    period = period_of(m)
    n_full, rem = split_periods(m)
    stack: Dict[str, Any] = {}
    for i in range(n_full):
        one = {f"b{j}": block_init(gen, kind, m, dtype)
               for j, kind in enumerate(period)}
        if i == 0:
            stack = tree_map(lambda a: a.new_empty((n_full, *a.shape)), one)
        tree_map(lambda dst, src: dst[i].copy_(src), stack, one)
    tail = {f"t{i}": block_init(gen, kind, m, dtype)
            for i, kind in enumerate(rem)}
    return stack, tail


def _with_layers_axis(tree):
    """Every Lg leaf of ``tree`` with the stacked "layers" axis in front."""
    return tree_map(lambda lg: Lg("layers", *lg), tree)


def _stack_specs(m: ModelConfig):
    period = period_of(m)
    n_full, rem = split_periods(m)
    one = {f"b{i}": block_specs(kind, m) for i, kind in enumerate(period)}
    stack = _with_layers_axis(one) if n_full else {}
    tail = {f"t{i}": block_specs(kind, m) for i, kind in enumerate(rem)}
    return stack, tail


def _encoder_model_cfg(m: ModelConfig) -> ModelConfig:
    """Encoder stack config: same dims, 'enc' blocks, encoder depth."""
    enc = dataclasses.replace(m, num_layers=m.encdec.encoder_layers,
                              family="dense")
    enc._force_kind = "enc"  # read by blocks.layer_kinds
    return enc


def lm_init(seed: int, m: ModelConfig, dtype=torch.float32, device=None
            ) -> Dict[str, Any]:
    """Random parameters from ``seed``, drawn on ``device`` (the GPU unless
    the caller names another)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    p: Dict[str, Any] = {}
    p["embed"] = L.embedding_init(gen, m.vocab_size, m.d_model, dtype)
    if m.first_dense_layers:
        p["lead"] = {f"l{i}": block_init(gen, kind, m, dtype)
                     for i, kind in enumerate(lead_kinds(m))}
    p["stack"], p["tail"] = _stack_init(gen, m, dtype)
    p["final_norm"] = norm_init(m, dtype, dev)
    if not m.tie_embeddings:
        p["head"] = {"w": L._normal(gen, (m.d_model, m.vocab_size),
                                    m.d_model ** -0.5, dtype)}
    if m.encdec.enabled:
        e_stack, e_tail = _stack_init(gen, _encoder_model_cfg(m), dtype)
        p["encoder"] = {"stack": e_stack, "tail": e_tail,
                        "norm": L.layernorm_init(m.d_model, dtype, dev)}
    return p


def lm_param_shapes(m: ModelConfig, dtype=torch.float32):
    """Parameter tree as :class:`~repro_torch.tree.ShapeDtype` leaves:
    :func:`lm_init` traced on fake tensors, nothing allocated."""
    with FakeTensorMode():
        return shapes_of(lm_init(0, m, dtype, device="cpu"))


def lm_specs(m: ModelConfig) -> Dict[str, Any]:
    """The logical axes of :func:`lm_init`'s tree, leaf for leaf."""
    p: Dict[str, Any] = {}
    p["embed"] = L.embedding_specs()
    if m.first_dense_layers:
        p["lead"] = {f"l{i}": block_specs(kind, m)
                     for i, kind in enumerate(lead_kinds(m))}
    p["stack"], p["tail"] = _stack_specs(m)
    p["final_norm"] = norm_specs(m)
    if not m.tie_embeddings:
        p["head"] = {"w": Lg("embed", "vocab")}
    if m.encdec.enabled:
        e_stack, e_tail = _stack_specs(_encoder_model_cfg(m))
        p["encoder"] = {"stack": e_stack, "tail": e_tail,
                        "norm": L.layernorm_specs()}
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _dots_policy(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep what a matrix product
    without batch dimensions returns (``aten.mm`` / ``aten.addmm``; a
    batched product is ``bmm``), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, remat: str):
    """``fn`` under the reference's ``remat`` policy: ``"full"`` keeps only
    its inputs for the backward, ``"dots"`` its un-batched matrix products
    too.  Where autograd records nothing there is no backward to serve, and
    ``fn`` runs as it is."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; one of {REMATS}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    extra = {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)} \
        if remat == "dots" else {}

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, **extra)
    return run


def _period_slices(stack, n: int):
    """The stack's ``n`` periods as trees of views, each leaf unbound once.
    (Indexing a leaf once a period would, under autograd, give every
    period's backward a zero tensor of the whole leaf to scatter into.)"""
    unbound = tree_map(lambda a: a.unbind(0), stack)
    return [tree_map(lambda u: u[i], unbound) for i in range(n)]


def _run_stack(stack, tail, x, m: ModelConfig, positions, cd, enc_out,
               use_kernel: bool, cache_len: int = 0,
               cache_dtype=torch.bfloat16, remat: str = "none", lead=None):
    """Run the leading blocks (``lead``), then the period-stacked blocks,
    each leading block and each period under ``remat`` (see
    :func:`_checkpointed`; not with a cache), then the tail. If
    cache_len > 0, also collect the decode cache produced by prefill
    (returned in init_decode_state layout)."""
    period = period_of(m)
    n_full, rem = split_periods(m)
    lead_cache = {}
    lead_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(lead_kinds(m)):
        def lead_fn(x, lp, kind=kind):
            return block_apply(kind, lp, x, m, positions, cd, enc_out,
                               use_kernel, cache_len, cache_dtype)
        f = lead_fn if cache_len else _checkpointed(lead_fn, remat)
        x, a, lead_cache[f"l{i}"] = f(x, lead[f"l{i}"])
        lead_aux = lead_aux + a

    def period_fn(x, pparams):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = {}
        for j, kind in enumerate(period):
            # the layer-boundary residual's sharding (sequence-parallel
            # under the production rules)
            x = constrain(x, ("batch", "seq", None))
            x, a, c = block_apply(kind, pparams[f"b{j}"], x, m, positions,
                                  cd, enc_out, use_kernel, cache_len,
                                  cache_dtype)
            aux = aux + a
            caches[f"b{j}"] = c
        return x, aux, caches

    f = period_fn if cache_len else _checkpointed(period_fn, remat)
    aux_total = lead_aux
    per_caches = []
    for pparams in _period_slices(stack, n_full):
        x, a, caches = f(x, pparams)
        aux_total = aux_total + a
        per_caches.append(caches)
    tail_cache = {}
    for i, kind in enumerate(rem):
        x, a, c = block_apply(kind, tail[f"t{i}"], x, m, positions, cd,
                              enc_out, use_kernel, cache_len, cache_dtype)
        aux_total = aux_total + a
        tail_cache[f"t{i}"] = c
    if cache_len:
        stack_cache = (tree_map(lambda *xs: torch.stack(xs), *per_caches)
                       if per_caches else {})
        state = {"stack": stack_cache, "tail": tail_cache}
        if lead_cache:
            state["lead"] = lead_cache
        return x, aux_total, state
    return x, aux_total, None


def _head(params, x, m: ModelConfig):
    """Final norm and the vocabulary projection, fp32 logits."""
    x = norm_apply(m, params["final_norm"], x)
    if m.tie_embeddings:
        return L.unembed_apply(params["embed"], x)
    # x in the compute dtype, the fp32 weight as it is: fp32 products,
    # accumulation and result, as the reference
    return L._f32_matmul(x, params["head"]["w"])


def encode(params, enc_embeds, m: ModelConfig, cd=None, remat: str = "full",
           scan_layers: bool = True) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, S_enc, d).  Its
    bidirectional attention takes the plain path, as in the reference."""
    se, d = enc_embeds.shape[1], m.d_model
    x = enc_embeds + L.sinusoidal_positions(se, d, enc_embeds.device).to(
        enc_embeds.dtype)
    enc = params["encoder"]
    x, _, _ = _run_stack(enc["stack"], enc["tail"], x, _encoder_model_cfg(m),
                         torch.arange(se, device=x.device), cd, None, False,
                         remat=remat)
    return L.layernorm_apply(enc["norm"], x)


def _embed(params, tokens, m: ModelConfig, cd):
    """Token embeddings of a prompt, scaled (hybrid) or with sinusoidal
    positions added (encoder-decoder) as the reference."""
    x = L.embedding_apply(params["embed"], tokens, cd)
    if m.family == HYBRID:                   # gemma-style embed scaling
        x = x * torch.tensor(m.d_model ** 0.5, dtype=x.dtype)
    if m.encdec.enabled:                     # whisper: sinusoidal positions
        x = x + L.sinusoidal_positions(tokens.shape[1], m.d_model,
                                       x.device).to(x.dtype)
    return x


def _encoder_out(params, batch, m: ModelConfig, cd, remat, scan_layers
                 ) -> Optional[torch.Tensor]:
    if not m.encdec.enabled:
        return None
    return encode(params, batch["enc_embeds"], m, cd, remat, scan_layers)


def lm_apply(params, batch: Dict[str, torch.Tensor], m: ModelConfig,
             cd=None, remat: str = "full", use_kernel: bool = False,
             positions=None, scan_layers: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B,S) int, ["enc_embeds": (B,Se,d)]}.  ``remat``
    is applied per period, to the encoder's too, where autograd records
    the forward; ``scan_layers`` is accepted for the reference's signature
    and changes nothing."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, tokens, m, cd)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    enc_out = _encoder_out(params, batch, m, cd, remat, scan_layers)
    x, aux, _ = _run_stack(params["stack"], params["tail"], x, m, positions,
                           cd, enc_out, use_kernel, remat=remat,
                           lead=params.get("lead"))
    return _head(params, x, m), aux


def lm_loss(params, batch: Dict[str, torch.Tensor], m: ModelConfig,
            cd=None, remat: str = "full", use_kernel: bool = False,
            scan_layers: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token xent. batch["labels"]: (B,S) with -1 = ignore."""
    logits, aux = lm_apply(params, batch, m, cd, remat, use_kernel,
                           scan_layers=scan_layers)
    labels = batch["labels"]
    valid = labels >= 0
    lab = torch.clamp(labels, min=0).to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    # the reference picks the label's logit by a one-hot contraction (a
    # sharding choice); a gather reads the same value
    picked = torch.gather(logits, -1, lab[..., None])[..., 0]
    nll = lse - picked
    denom = torch.clamp(torch.sum(valid), min=1)
    loss = torch.sum(nll * valid) / denom
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux,
                   "tokens": torch.sum(valid).to(torch.float32)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(m: ModelConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16, device=None):
    """Zero decode state, per-period leaves stacked on a leading axis, on
    ``device`` (the GPU unless the caller names another)."""
    dev = resolve_device(device)
    period = period_of(m)
    n_full, rem = split_periods(m)

    def one(kind):
        return block_state_init(kind, m, batch, cache_len, dtype, dev)

    stack = {}
    if n_full:
        one_p = {f"b{i}": one(kind) for i, kind in enumerate(period)}
        stack = tree_map(lambda x: x[None].repeat(n_full, *([1] * x.dim())),
                         one_p)
    tail = {f"t{i}": one(kind) for i, kind in enumerate(rem)}
    state = {"stack": stack, "tail": tail}
    if m.first_dense_layers:
        state["lead"] = {f"l{i}": one(kind)
                         for i, kind in enumerate(lead_kinds(m))}
    return state


def decode_state_shapes(m: ModelConfig, batch: int, cache_len: int,
                        dtype=torch.bfloat16):
    """:func:`init_decode_state`'s tree as ShapeDtype leaves, nothing
    allocated."""
    with FakeTensorMode():
        return shapes_of(init_decode_state(m, batch, cache_len, dtype,
                                           device="cpu"))


def decode_state_specs(m: ModelConfig):
    """The logical axes of :func:`init_decode_state`'s tree."""
    period = period_of(m)
    n_full, rem = split_periods(m)
    stack = {}
    if n_full:
        stack = _with_layers_axis({f"b{i}": block_state_specs(kind, m)
                                   for i, kind in enumerate(period)})
    tail = {f"t{i}": block_state_specs(kind, m) for i, kind in enumerate(rem)}
    state = {"stack": stack, "tail": tail}
    if m.first_dense_layers:
        state["lead"] = {f"l{i}": block_state_specs(kind, m)
                         for i, kind in enumerate(lead_kinds(m))}
    return state


def _write_back(dst, src):
    """Copy a block's new state into its (stacked) state views, leaving
    the leaves a block updated in place alone."""
    def put(d, s):
        if d is not s:
            d.copy_(s)
        return d
    tree_map(put, dst, src)


def lm_decode_step(params, token: torch.Tensor, state, index: int,
                   m: ModelConfig, cd=None, scan_layers: bool = True
                   ) -> Tuple[torch.Tensor, Any]:
    """token: (B,) int; index: the current position (a Python int).
    ``state`` is updated in place and returned."""
    period = period_of(m)
    n_full, rem = split_periods(m)
    index = int(index)
    x = L.embedding_apply(params["embed"], token[:, None], cd)
    if m.family == HYBRID:
        x = x * torch.tensor(m.d_model ** 0.5, dtype=x.dtype)
    if m.encdec.enabled:
        # the decoder's positions stop at its last one, as the reference
        mtp = m.encdec.max_target_positions
        pos_emb = L.sinusoidal_positions(mtp, m.d_model, x.device)[
            min(index, mtp - 1)]
        x = x + pos_emb.to(x.dtype)
    for i, kind in enumerate(lead_kinds(m)):
        x, s = block_decode(kind, params["lead"][f"l{i}"], x,
                            state["lead"][f"l{i}"], index, m, cd)
        _write_back(state["lead"][f"l{i}"], s)
    for i in range(n_full):
        pparams = tree_map(lambda a: a[i], params["stack"])
        pstate = tree_map(lambda a: a[i], state["stack"])
        for j, kind in enumerate(period):
            x, s = block_decode(kind, pparams[f"b{j}"], x, pstate[f"b{j}"],
                                index, m, cd)
            _write_back(pstate[f"b{j}"], s)
    for i, kind in enumerate(rem):
        x, s = block_decode(kind, params["tail"][f"t{i}"], x,
                            state["tail"][f"t{i}"], index, m, cd)
        _write_back(state["tail"][f"t{i}"], s)
    return _head(params, x, m)[:, 0], state


def lm_prefill(params, batch: Dict[str, torch.Tensor], m: ModelConfig,
               cache_len: int, cd=None, cache_dtype=torch.bfloat16,
               remat: str = "none", scan_layers: bool = True
               ) -> Tuple[torch.Tensor, Any, int]:
    """Process the full prompt, returning (last-token logits, decode state,
    next index). The cache is populated inside the forward pass (each
    block contributes its K/V / recurrent state), so prefill is one pass.
    Attention goes through ``layers.attention``: bf16 self-attention at an
    instantiated head_dim on the card takes the training flash op's
    forward (``kernels/flash_attention/train.py``), every other call the
    plain path, as in the reference."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, tokens, m, cd)
    enc_out = _encoder_out(params, batch, m, cd, remat, scan_layers)
    positions = torch.arange(s, device=x.device)
    x, _, state = _run_stack(params["stack"], params["tail"], x, m,
                             positions, cd, enc_out, False,
                             cache_len=cache_len, cache_dtype=cache_dtype,
                             lead=params.get("lead"))
    return _head(params, x[:, -1:], m)[:, 0], state, s
