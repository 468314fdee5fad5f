"""The DeepSeek-V2-Lite cell's parts on the CPU: its configuration file
against the catalog copy of the published config it names, its FLOP and
parameter counts by hand, the harness's last line with its metrics
(the card stubbed, the cell cut to its tiny size), and the new readers'
None where the program has no MLA and MoE spans or counters."""
import math
import sys
import types

import pytest

from perfbench import common, flops_mla
from perfbench.test_perfbench_run import _last_line, stub_card  # noqa: F401
from perfbench import run

CELL = "deepseek-v2-lite-16b.train_8k"
CONFIG = common.resolve_cell(CELL)["config"]
READERS = ("mla_ms.lm", "moe_ms.lm", "expert_fill.lm")


def test_model_block_is_the_published_config_cut_as_stated():
    """The port's settings (``model``) say what the published keys at the
    top of the file say; the two cut keys hold this card's share, beside
    their published counts."""
    c, m = CONFIG, CONFIG["model"]
    assert c["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert c["published"] == {"num_hidden_layers": 27,
                              "n_routed_experts": 64}
    assert m["num_layers"] == c["num_hidden_layers"] == 5
    assert m["num_experts"] == c["n_routed_experts"] == 32
    assert m["num_experts"] * m["expert_shards"] \
        == c["published"]["n_routed_experts"]
    assert m["expert_shards"] == c["expert_shards"] == 2
    assert m["expert_shard"] == c["expert_shard"] == 0
    ys = c["rope_scaling"]
    pairs = [("d_model", "hidden_size"), ("num_heads", "num_attention_heads"),
             ("num_kv_heads", "num_key_value_heads"),
             ("head_dim", "qk_nope_head_dim"), ("vocab_size", "vocab_size"),
             ("rope_theta", "rope_theta"), ("norm_eps", "rms_norm_eps"),
             ("tie_embeddings", "tie_word_embeddings"),
             ("d_ff", "intermediate_size"),
             ("first_dense_layers", "first_k_dense_replace"),
             ("num_shared_experts", "n_shared_experts"),
             ("top_k", "num_experts_per_tok"),
             ("d_ff_expert", "moe_intermediate_size"),
             ("norm_topk_prob", "norm_topk_prob"),
             ("kv_lora_rank", "kv_lora_rank"),
             ("rope_head_dim", "qk_rope_head_dim"),
             ("v_head_dim", "v_head_dim")]
    for port, pub in pairs:
        assert m[port] == c[pub], port
    assert c["q_lora_rank"] is None and m["q_lora_rank"] == 0
    assert ys["type"] == "yarn"
    # the port takes the factor from the file, the rest are its constants
    from repro_torch.models import mla
    assert (m["yarn_factor"], mla.YARN_ORIGINAL_MAX_POSITION,
            mla.YARN_BETA_FAST, mla.YARN_BETA_SLOW, mla.YARN_MSCALE_ALL_DIM,
            mla.YARN_MSCALE_ALL_DIM) == (
        ys["factor"], ys["original_max_position_embeddings"],
        ys["beta_fast"], ys["beta_slow"], ys["mscale"], ys["mscale_all_dim"])
    assert (c["scoring_func"], c["topk_method"], c["routed_scaling_factor"],
            c["n_group"], c["topk_group"], c["moe_layer_freq"]) == (
        "softmax", "greedy", 1, 1, 1, 1)


def test_counts_by_hand():
    m = CONFIG["model"]
    mla = 2048 * 16 * 192 + 2048 * 576 + 2 * 16 * 512 * 128 + 2048 * 2048
    moe = 2048 * 64 + 6 / 2 * 3 * 2048 * 1408 + 2 * 3 * 2048 * 1408
    active = mla + 3 * 2048 * 10944 + 4 * (mla + moe) + 2048 * 102400
    assert flops_mla.active_matmul_params(m) == active
    assert round(active / 1e6, 1) == 519.3
    step = flops_mla.lm_train_step(m, batch=4, seq_len=8192)
    assert step == 6 * active * 4 * 8192 + 5 * 4 * 3 * 8192 ** 2 * 16 * 320
    assert round(step / 1e12, 1) == 122.7


def test_parameter_tree_is_the_programs():
    drv = common.driver("lm_train_mla")
    shapes = drv.param_shapes(CONFIG["model"])
    assert sum(math.prod(s) for s, _ in shapes.values()) == 1_732_534_784
    assert shapes["lead/l0/mlp/down/w"] == ((10944, 2048),
                                            f"normal:{10944 ** -0.5}")
    assert shapes["stack/b0/mlp/experts/gate"][0] == (4, 32, 2048, 1408)
    assert shapes["stack/b0/mlp/router/w"] == ((4, 2048, 64), "normal:0.02")
    assert shapes["stack/b0/attn/kv_norm/scale"] == ((4, 512), "ones")


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_reports_the_cells_metrics(trace, stub_card, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(2**31 + 99),
                   "--seconds", "0.5", "--trace", str(trace)])
    assert rc == 0
    got = _last_line(capsys)
    assert got["correct"] is True and got["failed"] == 0
    spec = common.resolve_cell(CELL)
    want = {m["name"] for m in (spec["layer"] if trace else spec["e2e"])}
    assert want <= set(got["metrics"])
    if trace:
        assert 0 < got["metrics"]["expert_fill.lm"]["value"] <= 100
        assert got["metrics"]["mla_ms.lm"]["value"] > 0


def test_readers_give_none_without_the_programs_spans(monkeypatch):
    sess = types.SimpleNamespace(unit="step", traffic={"trace_steps": 2},
                                 step=lambda: pytest.fail("ran a step"))
    for name in READERS:
        assert common.reader(name)({"trace": None, "session": sess}) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs.trace",
                        types.ModuleType("repro_torch.obs.trace"))
    for name in READERS:
        assert common.reader(name)({"trace": {}, "session": sess}) is None


def test_new_per_layer_entries():
    entries = {m["name"]: m for m in common.benchmark()["per_layer"]}
    lm = ["olmoe-1b-7b.train_4k", CELL]
    want = {"mla_ms.lm": ("ms", "lower", "program_span",
                          "MLA attention (models/mla.py)", [CELL]),
            "moe_ms.lm": ("ms", "lower", "program_span",
                          "MoE layer (models/moe.py)", lm),
            "expert_fill.lm": ("%", "higher", "program_counter",
                               "MoE dispatch (models/moe.py)", lm)}
    for name, row in want.items():
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["workloads"]) == row and m["moves"] == "train_tok_s"
    for name in ("mfu.lm_train", "optim_ms.lm", "idle_share.lm"):
        assert entries[name]["workloads"] == lm
