"""The port's spec trees, shape trees and sharding layout against the JAX
package's, for every LM arch at full size and the DCGAN.

Nothing here allocates a full-size tensor: the port's shape functions run
its init on fake tensors, the reference's through ``jax.eval_shape``.
Equalities are exact (names, shapes, dtypes, partition specs).  Each
arch's trees are built once, in a module fixture.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_fixtures import one_thread  # noqa: F401
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.launch import specs as jls
from repro.models import dcgan as jdcgan
from repro.models import transformer as jtf
from repro.sharding import specs as jspecs
from repro_torch.configs import registry as treg
from repro_torch.launch import specs as tls
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import dcgan as tdcgan
from repro_torch.models import transformer as ttf
from repro_torch.sharding import specs as tspecs
from repro_torch.tree import leaves, shapes_of

ARCHS = treg.ASSIGNED_ARCHS
MESHES = {"pod16x16": ((16, 16), ("data", "model"), False),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}


def _jpaths(tree, is_leaf=None):
    """(path of keys, leaf) pairs of a JAX tree, in its leaf order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(tuple(k.key for k in path), leaf) for path, leaf in flat]


def _tpaths(tree, prefix=()):
    """(path of keys, leaf) pairs of a port tree, in its leaf order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(_tpaths(tree[k], prefix + (k,)))
    return out


def _shape_dtypes_equal(jtree, ttree):
    jp, tp = _jpaths(jtree), _tpaths(ttree)
    assert [p for p, _ in jp] == [p for p, _ in tp]
    for (path, j), (_, t) in zip(jp, tp):
        assert tuple(j.shape) == tuple(t.shape), path
        assert str(j.dtype) == str(t.dtype).replace("torch.", ""), path


def _specs_equal(jtree, ttree):
    jp = _jpaths(jtree, is_leaf=jspecs.is_lg)
    tp = _tpaths(ttree)
    assert [p for p, _ in jp] == [p for p, _ in tp]
    for (path, j), (_, t) in zip(jp, tp):
        assert tspecs.is_lg(t), path
        assert tuple(j) == tuple(t), path


class Trees:
    """One arch's trees in both packages, at full size."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg, self.tcfg = jreg.get_config(arch), treg.get_config(arch)
        jtrain = jreg.get_config(arch, "train_4k")
        ttrain = treg.get_config(arch, "train_4k")
        # lm_param_shapes in the config's parameter dtype
        self.jp = jls.param_shapes(jtrain)
        self.tp = tls.param_shapes(ttrain)
        self.jopt = jls.opt_shapes(jtrain, self.jp)
        self.topt = tls.opt_shapes(ttrain, self.tp)


@pytest.fixture(scope="module", params=ARCHS)
def trees(request):
    return Trees(request.param)


def test_lm_specs_match_reference(trees):
    _specs_equal(jtf.lm_specs(trees.jcfg.model), ttf.lm_specs(trees.tcfg.model))
    _specs_equal(jtf.decode_state_specs(trees.jcfg.model),
                 ttf.decode_state_specs(trees.tcfg.model))


def test_param_shapes_match_reference_full_size(trees):
    """``lm_param_shapes`` (fake tensors) against the reference's
    ``jax.eval_shape`` tree: every leaf's path, shape and dtype."""
    _shape_dtypes_equal(trees.jp, trees.tp)


def test_param_specs_match_param_shapes_full_size(trees):
    """Twin of tests/test_spec_trees.py's: one spec leaf a parameter, of
    its rank."""
    shapes, specs = trees.tp, ttf.lm_specs(trees.tcfg.model)
    assert [p for p, _ in _tpaths(shapes)] == [p for p, _ in _tpaths(specs)]
    for p, s in zip(leaves(shapes), leaves(specs)):
        assert len(s) == len(p.shape), (trees.arch, p.shape, tuple(s))


def test_decode_state_shapes_match_reference(trees):
    m_j, m_t = trees.jcfg.model, trees.tcfg.model
    _shape_dtypes_equal(jtf.decode_state_shapes(m_j, 4, 128),
                        ttf.decode_state_shapes(m_t, 4, 128))
    shapes, specs = ttf.decode_state_shapes(m_t, 4, 128), \
        ttf.decode_state_specs(m_t)
    assert [p for p, _ in _tpaths(shapes)] == [p for p, _ in _tpaths(specs)]
    for p, s in zip(leaves(shapes), leaves(specs)):
        assert len(s) == len(p.shape), (trees.arch, p.shape, tuple(s))


def test_full_param_shapes_match_analytic_count(trees):
    """Twin of tests/test_spec_trees.py's (8%), and the same total as the
    reference's tree exactly."""
    total = sum(int(np.prod(s.shape)) for s in leaves(trees.tp))
    analytic = trees.tcfg.model.param_count()
    assert abs(total - analytic) / analytic < 0.08
    assert total == sum(int(np.prod(s.shape))
                        for s in jax.tree.leaves(trees.jp))


def test_opt_shapes_match_reference(trees):
    """``opt_shapes``: the port's optimizer init on fake tensors against
    the reference's ``jax.eval_shape(opt.init)``."""
    _shape_dtypes_equal(trees.jopt, trees.topt)


def _tspecs_of(shardings):
    return [tuple(s.spec) for s in leaves(shardings)]


def _jspecs_of(shardings):
    return [tuple(s.spec) for s in jax.tree.leaves(shardings)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_over_every_leaf_match_reference(trees, mesh_name):
    """``default_rules`` and ``logical_spec`` over every parameter and
    optimizer leaf, on the production meshes, against the reference's on
    ``AbstractMesh`` (twin of tests/test_sharding_roofline.py's rules)."""
    sizes, names, multi = MESHES[mesh_name]
    jm, tm = AbstractMesh(sizes, names), make_production_mesh(
        multi_pod=multi)
    assert tm.shape == dict(jm.shape)
    jr, tr = jspecs.default_rules(jm), tspecs.default_rules(tm)
    assert jr.rules == tr.rules
    jtrain = jreg.get_config(trees.arch, "train_4k")
    ttrain = treg.get_config(trees.arch, "train_4k")
    assert _tspecs_of(tls.param_shardings(ttrain, tm, trees.tp)) == \
        _jspecs_of(jls.param_shardings(jtrain, jm, trees.jp))
    jo = jls.opt_shardings(jtrain, jm, trees.jp)
    to = tls.opt_shardings(ttrain, tm, trees.tp)
    assert sorted(jo) == sorted(to)
    for k in jo:
        assert _tspecs_of(to[k]) == _jspecs_of(jo[k]), k
    # spec_for_param on each leaf gives the same as the tree's
    for (path, s), lg in zip(_tpaths(trees.tp), leaves(
            ttf.lm_specs(ttrain.model))):
        want = jspecs.logical_spec(jm, jr, s.shape, tuple(lg))
        assert tuple(tspecs.spec_for_param(tm, tr, s, lg).spec) == \
            tuple(want), path


def test_pairs_match_reference():
    """Twin of tests/test_config.py's 40-pair matrix."""
    assert treg.ASSIGNED_ARCHS == jreg.ASSIGNED_ARCHS
    pairs = list(treg.iter_pairs(include_skipped=True))
    assert len(pairs) == 40
    assert [(a, s) for a, s, c in pairs if c is None] == \
        [("whisper-base", "long_500k")]
    assert [(a, s) for a, s, _ in pairs] == \
        [(a, s) for a, s, _ in jreg.iter_pairs(include_skipped=True)]
    assert len(list(treg.iter_pairs())) == 39


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_batch_shardings_match_reference(arch):
    """``input_specs`` and ``batch_shardings`` (both meshes) for each of
    the arch's pairs; ``batch_tokens`` too."""
    for _, shape, tcfg in treg.iter_pairs():
        if _ != arch:
            continue
        jcfg = jreg.get_config(arch, shape)
        assert tls.batch_tokens(tcfg) == jls.batch_tokens(jcfg)
        ji, ti = jls.input_specs(jcfg), tls.input_specs(tcfg)
        _shape_dtypes_equal(ji, ti)
        for sizes, names, multi in MESHES.values():
            jm = AbstractMesh(sizes, names)
            tm = make_production_mesh(multi_pod=multi)
            jb, tb = jls.batch_shardings(jcfg, jm, ji), \
                tls.batch_shardings(tcfg, tm, ti)
            assert sorted(jb) == sorted(tb)
            for k in jb:
                assert _tspecs_of(tb[k]) == _jspecs_of(jb[k]), (shape, k)


def test_dcgan_specs_match_reference():
    jcfg, tcfg = jreg.get_config("dcgan-mnist"), treg.get_config(
        "dcgan-mnist")
    c_j, c_t = jcfg.model.dcgan, tcfg.model.dcgan
    _specs_equal(jdcgan.disc_specs(c_j), tdcgan.disc_specs(c_t))
    _specs_equal(jdcgan.gen_specs(c_j), tdcgan.gen_specs(c_t))
    gen = torch.Generator().manual_seed(0)
    for init, specs in ((tdcgan.disc_init, tdcgan.disc_specs),
                        (tdcgan.gen_init, tdcgan.gen_specs)):
        params = shapes_of(init(gen, c_t, "cpu"))
        assert [p for p, _ in _tpaths(params)] == \
            [p for p, _ in _tpaths(specs(c_t))]
        for p, s in zip(leaves(params), leaves(specs(c_t))):
            assert len(s) == len(p.shape)


def test_shape_functions_allocate_nothing():
    """llama3-405b's 811.7 GB of bf16 parameters, as shapes and dtypes
    only (the process would not hold them otherwise)."""
    shapes = ttf.lm_param_shapes(treg.get_config("llama3-405b").model,
                                 torch.bfloat16)
    assert round(sum(s.nbytes for s in leaves(shapes)) / 1e9, 1) == 811.7
    assert all(s.dtype == torch.bfloat16 for s in leaves(shapes))
