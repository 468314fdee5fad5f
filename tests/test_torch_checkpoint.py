"""The port's batch iterator and checkpoints (``repro_torch/data/pipeline``,
``repro_torch/checkpoint``) held against the JAX package on the CPU.

``BatchIterator`` is numpy in both packages: the same seed gives the same
batches, element for element.  The checkpoint format is the JAX
package's, so a file written by either loads in the other bit for bit,
bf16 leaves included.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_fixtures import cuda, one_thread  # noqa: F401

from repro.checkpoint import load_pytree as jload_pytree
from repro.checkpoint import save_pytree as jsave_pytree
from repro.data import BatchIterator as JBatchIterator
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    save_pytree)
from repro_torch.data import BatchIterator
from repro_torch.tree import leaves


def _bits(t):
    """A tensor's bytes as numpy integers (bf16 included)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


# ---------------------------------------------------------------------------
# the batch iterator
# ---------------------------------------------------------------------------

def test_batch_iterator_drop_last():
    """Twin of the reference's ``test_batch_iterator_drop_last``."""
    it = BatchIterator(np.arange(10), batch_size=3, seed=0)
    batches = list(it.epoch())
    assert len(batches) == 3
    assert all(len(b) == 3 for b in batches)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("as_dict", [True, False])
def test_batch_iterator_epochs_match_jax(drop_last, as_dict):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((23, 4)).astype(np.float32)
    data = {"x": x, "y": np.arange(23)} if as_dict else x
    it = BatchIterator(data, batch_size=5, seed=7, drop_last=drop_last)
    jit = JBatchIterator(data, batch_size=5, seed=7, drop_last=drop_last)
    assert len(it) == len(jit) == (4 if drop_last else 5)
    for _ in range(3):                        # the rng carries across epochs
        got, want = list(it.epoch()), list(jit.epoch())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if as_dict:
                assert g.keys() == w.keys()
                for k in g:
                    np.testing.assert_array_equal(g[k], w[k])
            else:
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(device="cpu"):
    """A tree with a bf16 leaf, ints, a 0-d leaf and a list, as tensors."""
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn((3, 4), generator=g).to(torch.bfloat16),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(2.5)},
            "e": [torch.randn((2,), generator=g), torch.zeros((1, 1))]}


def _jtree():
    return {"a": (jax.random.normal(jax.random.PRNGKey(1), (3, 4))
                  ).astype(jnp.bfloat16),
            "b": {"c": jnp.arange(5, dtype=jnp.int32), "d": jnp.asarray(2.5)},
            "e": [jax.random.normal(jax.random.PRNGKey(2), (2,)),
                  jnp.zeros((1, 1))]}


def test_checkpoint_roundtrip(tmp_path):
    """Twin of the reference's ``test_checkpoint_roundtrip``."""
    tree = {"a": torch.ones((3, 4), dtype=torch.bfloat16),
            "b": {"c": torch.arange(5), "d": torch.tensor(2.5)}}
    p = os.path.join(tmp_path, "x.npz")
    save_pytree(p, tree, {"note": "hi"})
    got, extra = load_pytree(p, like=tree)
    assert extra["note"] == "hi"
    for a, b in zip(leaves(tree), leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_manager_retention(tmp_path):
    """Twin of the reference's ``test_checkpoint_manager_retention``."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.steps() == [3, 4]
    _, extra = mgr.restore(like=tree)
    assert extra["step"] == 4
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_jax_checkpoint_loads_in_the_port_bit_for_bit(tmp_path):
    p = os.path.join(tmp_path, "jax.npz")
    jt = _jtree()
    jsave_pytree(p, jt, {"round": 3})
    got, extra = load_pytree(p, like=_tree())
    assert extra == {"round": 3}
    assert got["a"].dtype == torch.bfloat16 and isinstance(got["e"], list)
    for g, w in zip(leaves(got["b"]) + [got["a"]] + got["e"],
                    jax.tree.leaves(jt["b"]) + [jt["a"]] + jt["e"]):
        want = np.asarray(w)
        if want.dtype == jnp.bfloat16:
            want = want.view(np.int16)
        np.testing.assert_array_equal(_bits(g), want)
        assert g.shape == want.shape


def test_port_checkpoint_loads_in_jax_bit_for_bit(tmp_path):
    p = os.path.join(tmp_path, "port.npz")
    tree = _tree()
    save_pytree(p, tree, {"step": 9})
    got, extra = jload_pytree(p, like=_jtree())
    assert extra == {"step": 9}
    assert got["a"].dtype == jnp.bfloat16
    pairs = [(got["a"], tree["a"]), (got["b"]["c"], tree["b"]["c"]),
             (got["b"]["d"], tree["b"]["d"]), (got["e"][0], tree["e"][0]),
             (got["e"][1], tree["e"][1])]
    for g, w in pairs:
        g = np.asarray(g)
        if g.dtype == jnp.bfloat16:
            g = g.view(np.int16)
        np.testing.assert_array_equal(g, _bits(w))


def test_load_without_like_returns_cpu_tensors(tmp_path):
    p = os.path.join(tmp_path, "x.npz")
    tree = _tree()
    save_pytree(p, tree)
    flat, extra = load_pytree(p)
    assert extra == {}
    assert sorted(flat) == ["a", "b//c", "b//d", "e//0", "e//1"]
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in flat.values())
    assert flat["a"].dtype == torch.bfloat16
    assert torch.equal(flat["a"], tree["a"])
    assert torch.equal(flat["b//c"], tree["b"]["c"])
    # the JAX package reads the same file without a template too
    jflat, _ = jload_pytree(p)
    assert sorted(jflat) == sorted(flat)


def test_load_with_like_takes_its_dtypes_and_raises_on_missing(tmp_path):
    p = os.path.join(tmp_path, "x.npz")
    save_pytree(p, {"w": torch.arange(4, dtype=torch.float32)})
    got, _ = load_pytree(p, like={"w": torch.zeros(4, dtype=torch.float64)})
    assert got["w"].dtype == torch.float64
    with pytest.raises(KeyError, match="missing"):
        load_pytree(p, like={"w": torch.zeros(4), "v": torch.zeros(1)})


@pytest.mark.gpu
def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    p = os.path.join(tmp_path, "x.npz")
    tree = _tree()
    save_pytree(p, tree)
    like = {"a": tree["a"].cuda(), "b": {"c": tree["b"]["c"],
                                         "d": tree["b"]["d"].cuda()},
            "e": [t.cuda() for t in tree["e"]]}
    got, _ = load_pytree(p, like=like)
    for g, want, ref in zip(leaves(got["b"]) + [got["a"]] + got["e"],
                            leaves(tree["b"]) + [tree["a"]] + tree["e"],
                            leaves(like["b"]) + [like["a"]] + like["e"]):
        assert g.device == ref.device and g.dtype == ref.dtype
        assert torch.equal(g.cpu(), want)
    # saved from the card, it loads back the same
    save_pytree(p, like)
    back, _ = load_pytree(p, like=tree)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back["b"]),
                                                  leaves(tree["b"])))
