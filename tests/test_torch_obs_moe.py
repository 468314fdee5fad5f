"""The MLA and MoE layers' spans and the MoE layer's counters
(``repro_torch/obs/trace.py`` ``span`` / ``count``): an ``mla`` and a
``moe`` span once a layer in each forward pass the program runs itself
(remat's recompute in the backward opens none), the counters equal to a
host recount of the routing, read once a step, and with no active tracer
a train step that reads nothing on the host.

No JAX here.
"""
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import MoEConfig, reduce_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import Tracer, tracing
from repro_torch.optim import make_optimizer
from repro_torch.runtime import make_train_step

# the operators that read a device value on the host (a sync on the card)
HOST_READS = ("aten._local_scalar_dense.default", "aten.nonzero.default",
              "aten.item.default")


def _deepseek(nmb=2):
    cfg = reduce_for_smoke(get_config("deepseek-v2-lite-16b", "train_4k"),
                           seq_len=16, batch=4)
    return cfg.override({
        "model.num_layers": 3, "model.first_dense_layers": 1,
        "model.d_ff": 96, "model.moe.expert_shards": 2,
        "model.moe.norm_topk_prob": False, "model.mla.yarn_factor": 40.0,
        "parallel.microbatches": nmb, "parallel.remat": "full",
        "optim.schedule": "constant", "optim.warmup_steps": 0}).validate()


def _step_inputs(cfg):
    m = cfg.model
    params = T.lm_init(0, m, device="cpu")
    opt = make_optimizer(cfg.optim).init(params)
    tok = torch.randint(0, m.vocab_size, (4, 17),
                        generator=torch.Generator().manual_seed(0))
    return params, opt, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _names(tracer):
    out = {}
    for s in tracer.spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_spans_once_a_layer_in_each_forward_the_program_runs():
    """Train step, 2 micro-batches, remat full: each micro-batch's forward
    opens an ``mla`` span a layer (the dense one too) and a ``moe`` span
    a MoE layer, inside its ``microbatch``; the backward's recompute opens
    none.  Prefill and each decode step: one a layer."""
    cfg = _deepseek()
    m = cfg.model
    params, opt, batch = _step_inputs(cfg)
    tr = Tracer("t")
    with tracing(tr):
        make_train_step(cfg)(params, opt, batch, 5)
    got = _names(tr)
    assert got["mla"] == 3 * 2 and got["moe"] == 2 * 2
    by_id = {s.span_id: s for s in tr.spans}
    for s in tr.spans:
        if s.name in ("mla", "moe"):
            assert by_id[s.parent_id].name == "microbatch" and s.index == 5
    tr = Tracer("serve")
    with tracing(tr):
        _, state, idx = T.lm_prefill(params, {"tokens": batch["tokens"]},
                                     m, cache_len=20)
        assert _names(tr) == {"mla": 3, "moe": 2}
        T.lm_decode_step(params, batch["tokens"][:, 0], state, idx, m)
    assert _names(tr) == {"mla": 6, "moe": 4}


def _recount(x, router, cfg, groups):
    """The routing counted on the host, token by token: each group's
    token-slots routed to the held experts, those within an expert's
    capacity (in token order), and the capacity rows."""
    e, k = cfg.num_experts, cfg.top_k
    e0, n = cfg.held_experts
    xt = x.reshape(groups, -1, x.shape[-1])
    tg = xt.shape[1]
    cap = int(max(k, (tg * k * cfg.capacity_factor / e) // 1 + 1))
    routed = kept = 0
    for gi in range(groups):
        probs = torch.softmax(xt[gi] @ router, dim=-1)
        top = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]
        seen = [0] * e
        for t in range(tg):
            for ex in top[t].tolist():
                if e0 <= ex < e0 + n:
                    routed += 1
                    kept += seen[ex] < cap
                seen[ex] += 1
    return {"moe_routed": routed, "moe_kept": kept,
            "moe_dropped": routed - kept,
            "moe_capacity": groups * n * cap}


@pytest.mark.parametrize("shards,shard", [(1, 0), (2, 1), (4, 2)])
def test_counters_equal_a_host_recount(shards, shard):
    cfg = MoEConfig(num_experts=8, num_shared_experts=1, top_k=2,
                    d_ff_expert=16, capacity_factor=1.0,
                    expert_shards=shards, expert_shard=shard)
    p = M.moe_init(torch.Generator().manual_seed(3), 32, cfg)
    x = torch.randn(2, 48, 32, generator=torch.Generator().manual_seed(4))
    tr = Tracer("t")
    with tracing(tr):
        with obs_trace.span("step", index=0):
            M.moe_apply(p, x, cfg)
            M.moe_apply(p, x, cfg)
    want = _recount(x, p["router"]["w"], cfg, M._dispatch_groups(96, 2))
    assert want["moe_dropped"] > 0
    assert tr.counters == {0: {k: 2 * v for k, v in want.items()}}


class _HostReads(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += str(func) in HOST_READS
        return func(*args, **(kwargs or {}))


def test_no_tracer_no_host_read_and_one_read_a_step_with_one(monkeypatch):
    """A train step of the MoE model reads no device value on the host
    with no active tracer (the counters cost nothing there: a step without
    them reads none either); with a tracer they add one read a step,
    where the step's span closes."""
    cfg = _deepseek()
    params, opt, batch = _step_inputs(cfg)
    step = make_train_step(cfg)
    lists = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda t: lists.append(t.shape) or real(t))
    with _HostReads() as reads:
        step(params, opt, batch, 0)
    assert reads.n == 0 and lists == []
    tr = Tracer("t")
    with tracing(tr), _HostReads() as reads:
        step(params, opt, batch, 1)
        step(params, opt, batch, 2)
    # routed, kept, dropped: one device read (the capacity is the host's)
    assert reads.n == 0 and lists == [(3,), (3,)]
    assert set(tr.counters) == {1, 2}
    assert tr.counters[1]["moe_capacity"] > 0
