"""The port's uplink codecs and the engine's codec path held against the
JAX package on the CPU.

The same numpy inputs go through ``repro.fed.transport`` and
``repro_torch.fed.transport``.  Wire bytes must be equal exactly.  The
fp16 and int8 round-trips are elementwise IEEE arithmetic (a cast; a true
division, round half to even, a product), so they must agree bit for bit.
``torch.topk`` and ``jax.lax.top_k`` may keep different entries among
equal magnitudes, so top-k is compared on inputs without ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401

from repro.configs.registry import get_config as jget_config
from repro.fed import transport as jt
from repro.fed.engine import ClientSpec as JClientSpec
from repro.fed.engine import FederationEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_config
from repro_torch.fed import transport as tt
from repro_torch.fed.engine import ClientSpec, FederationEngine
from repro_torch.tree import leaves

CODECS = ("none", "fp16", "int8", "topk")


def _tree(seed, scale=1.0):
    """A small parameter-like tree; magnitudes are distinct (no top-k
    ties) and one leaf is all zeros (the int8 scale-1.0 branch)."""
    rng = np.random.default_rng(seed)
    w = rng.permutation(np.arange(1, 6 * 7 + 1)).reshape(6, 7)
    return {"a": {"w": (w * 0.013 * scale * rng.choice([-1, 1], (6, 7))
                        ).astype(np.float32),
                  "b": np.zeros(5, np.float32)},
            "c": (rng.standard_normal(33) * scale).astype(np.float32)}


def _assert_trees_equal(got, want):
    gl, wl = leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", CODECS)
def test_codec_roundtrip_matches_jax(name):
    tree = _tree(1)
    jc = jt.make_codec(name, topk_frac=0.2)
    tc = tt.make_codec(name, topk_frac=0.2)
    assert tc.encodes_delta == jc.encodes_delta
    for r in range(3):          # top-k error feedback carries a residual
        t = jax.tree.map(lambda l, r=r: l * (1.0 + 0.25 * r), tree)
        jdec, jbytes = jc.roundtrip(jax.tree.map(jnp.asarray, t))
        dec, nbytes = tc.roundtrip(params_from_numpy(t, "cpu"))
        assert nbytes == jbytes
        _assert_trees_equal(dec, jdec)


@pytest.mark.parametrize("name", CODECS)
def test_codec_encode_decode_matches_jax(name):
    x = _tree(2)["a"]["w"]
    jc = jt.make_codec(name, topk_frac=0.3, error_feedback=False)
    tc = tt.make_codec(name, topk_frac=0.3, error_feedback=False)
    jwire, jmeta = jc.encode(jnp.asarray(x))
    wire, meta = tc.encode(torch.tensor(x))
    got = tc.decode(wire, meta, torch.float32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc.decode(jwire, jmeta, jnp.float32)))
    np.testing.assert_array_equal(
        got.numpy(), tc.roundtrip(torch.tensor(x))[0].numpy())
    if name == "int8":
        np.testing.assert_array_equal(wire.numpy(), np.asarray(jwire))
        assert float(meta) == float(jmeta)


@pytest.mark.parametrize("name", CODECS)
def test_codec_encode_tree_matches_jax(name):
    tree = _tree(3)
    jc, tc = jt.make_codec(name, topk_frac=0.2), tt.make_codec(
        name, topk_frac=0.2)
    for _ in range(2):
        jenc, jbytes = jc.encode_tree(jax.tree.map(jnp.asarray, tree))
        enc, nbytes = tc.encode_tree(params_from_numpy(tree, "cpu"))
        assert nbytes == jbytes and len(enc) == len(jenc)
        for (w, m), (jw, jm) in zip(enc, jenc):
            np.testing.assert_array_equal(
                tc.decode(w, m).numpy(), np.asarray(jc.decode(jw, jm)))


@pytest.mark.parametrize("name", CODECS)
def test_predict_codec_bytes_matches_jax(name):
    sizes = [1, 7, 100, 4097, 819200]
    for frac in (0.01, 0.3, 1.0):
        assert tt.predict_codec_bytes(name, sizes, topk_frac=frac) == \
            jt.predict_codec_bytes(name, sizes, topk_frac=frac)
    tree = _tree(4)
    _, nbytes = tt.make_codec(name, topk_frac=0.2).roundtrip(
        params_from_numpy(tree, "cpu"))
    assert nbytes == tt.predict_codec_bytes(
        name, [l.size for l in jax.tree.leaves(tree)], topk_frac=0.2)


def test_tree_rel_error_matches_jax():
    a, b = _tree(5), _tree(6, scale=1.1)
    got = tt.tree_rel_error(params_from_numpy(a, "cpu"),
                            params_from_numpy(b, "cpu"))
    np.testing.assert_allclose(got, jt.tree_rel_error(a, b), rtol=1e-12)
    assert tt.tree_rel_error(params_from_numpy(a, "cpu"),
                             params_from_numpy(a, "cpu")) == 0.0


def test_int8_rounds_half_to_even_and_keeps_zero_leaves():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    dec, _ = tt.Int8Codec().roundtrip({"x": x})
    np.testing.assert_array_equal(dec["x"].numpy(),
                                  [127.0, 0.0, 2.0, 2.0, -0.0, -2.0])
    zeros, _ = tt.Int8Codec().roundtrip({"z": torch.zeros(4)})
    assert torch.equal(zeros["z"], torch.zeros(4))


@pytest.mark.parametrize("name", CODECS)
def test_engine_codec_round_matches_jax(name):
    """The engine uplinks deltas through each codec (bare-callable program
    moving every leaf): decoded global, wire bytes and codec error."""
    over = {"fed.codec": name, "fed.topk_frac": 0.2}
    base = _tree(7)
    specs = [("c0", 10.0, 0.5), ("c1", 30.0, 1.0)]
    jeng = JEngine(jget_config("dcgan-mnist").override(over).fed,
                   [JClientSpec(*s) for s in specs])
    eng = FederationEngine(get_config("dcgan-mnist").override(over).fed,
                           [ClientSpec(*s) for s in specs])
    moved = {cid: _tree(8 + i, scale=0.1) for i, cid in enumerate(
        ("c0", "c1"))}

    def jlocal(cid, p):
        return jax.tree.map(lambda a, d: a + d, p, moved[cid]), {}

    def local(cid, p):
        d = params_from_numpy(moved[cid], "cpu")
        return {k: (v + d[k] if not isinstance(v, dict)
                    else {kk: vv + d[k][kk] for kk, vv in v.items()})
                for k, v in p.items()}, {}

    jg, g = jax.tree.map(jnp.asarray, base), params_from_numpy(base, "cpu")
    for _ in range(2):
        jrep = jeng.run_round(jg, jlocal, down_bytes=1000)
        rep = eng.run_round(g, local, down_bytes=1000)
        assert rep.traffic.up_bytes == jrep.traffic.up_bytes
        assert rep.round_time_s == jrep.round_time_s
        for cid in rep.codec_error:
            np.testing.assert_allclose(rep.codec_error[cid],
                                       jrep.codec_error[cid], rtol=1e-6,
                                       atol=1e-12)
        for x, y in zip(leaves(rep.global_params),
                        jax.tree.leaves(jrep.global_params)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                       atol=1e-7)
        jg, g = jrep.global_params, rep.global_params
