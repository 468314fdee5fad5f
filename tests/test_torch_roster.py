"""The port's lazy roster (``repro_torch/fed/roster.py``) held against the
JAX package on the CPU.

``jax.random`` cannot be reproduced, so the sampled ids differ from the
reference's: sampling is held to its contract (pure in ``(seed, round,
cohort)``, distinct ids inside their cohort, the quotas), and everything
closed-form to the reference's values exactly.  The roster's cohorts drive
the edge hierarchy's two-tier reduce, held against the flat FedAvg.
"""
import time

import numpy as np
import pytest
import torch
from _torch_fixtures import cuda, one_thread  # noqa: F401

from repro.fed.hierarchy import assign_cohorts as jassign_cohorts
from repro.fed.roster import Roster as JRoster
from repro.fed.transport import LinkModel as JLinkModel
from repro_torch import keys
from repro_torch.fed.engine import ClientSpec
from repro_torch.fed.hierarchy import HierarchicalAggregator, assign_cohorts
from repro_torch.fed.roster import Roster, _sample_indices
from repro_torch.fed.transport import LinkModel
from repro_torch.kernels.fedavg.ops import fedavg_trees
from repro_torch.kernels.fedavg.ref import fedavg_leaves_ref
from repro_torch.tree import leaves, unflatten_like

GRID = [(1, 1, 1, 1.0), (100, 100, 1, 1.0), (10_000, 16, 4, 1.0),
        (10_007, 33, 5, 0.7), (1_000_000, 64, 8, 0.25), (17, 9, 9, 0.5)]


# ---------------------------------------------------------------------------
# twins of the reference's roster tests
# ---------------------------------------------------------------------------

def test_roster_resampling_reproducible_and_cohort_consistent():
    r = Roster(10_000, participants=16, cohorts=4, seed=3)
    s1, s2 = r.sample_round(7), r.sample_round(7)
    assert s1 == s2
    assert len(set(s1.client_ids)) == 16
    assert s1.client_ids != r.sample_round(8).client_ids
    for cid, c in zip(s1.client_ids, s1.cohorts):
        lo, hi = r.cohort_range(c)
        assert lo <= cid < hi
        assert r.cohort_of(cid) == c


def test_roster_key_chain_varies_each_component():
    r = Roster(1000, participants=8, cohorts=2, seed=0)
    base = r.client_key(1, 0, 42)
    others = (r.client_key(2, 0, 42), r.client_key(1, 1, 42),
              r.client_key(1, 0, 43), Roster(1000, participants=8, cohorts=2,
                                              seed=1).client_key(1, 0, 42))
    for other in others:
        assert other != base and keys.seed_of(other) != keys.seed_of(base)
    assert base == r.client_key(1, 0, 42)
    # a path of the port's noise keys, under its own source
    assert base[:2] == keys.root(keys.ROSTER, 0) and base[2:] == (1, 0, 42)


def test_roster_large_population_samples_lazily():
    r = Roster(1_000_000, participants=64, cohorts=8, seed=1)
    s = r.sample_round(0)
    assert len(set(s.client_ids)) == 64
    assert s == r.sample_round(0)
    assert r.sample_rate == 64 / 1_000_000


def test_roster_subsampling_amplifies_epsilon():
    r = Roster(100_000, participants=100, cohorts=4, seed=0)
    amplified = r.amplified_epsilon(1.1, rounds=50)
    full = Roster(100, participants=100, seed=0).amplified_epsilon(
        1.1, rounds=50)
    assert amplified < full / 10
    acct = r.accountant(1.1)
    acct.step(50)
    assert abs(acct.epsilon(1e-5)[0] - amplified) < 1e-9


def test_roster_analytic_pricing_monotone():
    r = Roster(10_000, participants=32, cohorts=4, seed=0)
    bigger = Roster(10_000, participants=256, cohorts=4, seed=0)
    assert bigger.barrier_compute_s() > r.barrier_compute_s()
    nb = 1 << 20
    assert r.wan_bytes_per_round(nb) == 32 * nb
    assert r.wan_bytes_per_round(nb, hierarchical=True) == 4 * nb
    assert r.wan_bytes_per_round(nb) \
        >= (32 / 4) * r.wan_bytes_per_round(nb, hierarchical=True)
    specs = r.specs_for_round(3)
    assert len(specs) == 32 and all(isinstance(s, ClientSpec) for s in specs)
    assert all(s.compute_time_s > 0 for s in specs)
    assert all(r.cohort_of_cid(s.client_id) == c
               for s, c in zip(specs, r.sample_round(3).cohorts))


def test_roster_rejects_bad_arguments():
    for kw in ({"population": 0, "participants": 1},
               {"population": 5, "participants": 6},
               {"population": 5, "participants": 2, "cohorts": 3},
               {"population": 5, "participants": 2, "availability": 0.0}):
        with pytest.raises(ValueError):
            Roster(kw.pop("population"), **kw)
    with pytest.raises(ValueError):
        Roster(5, participants=2).finish_quantile(1.0)


# ---------------------------------------------------------------------------
# closed form: equal to the reference exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pop,m,cohorts,avail", GRID)
def test_closed_form_matches_jax(pop, m, cohorts, avail):
    kw = dict(participants=m, cohorts=cohorts, seed=2, availability=avail)
    r, j = Roster(pop, **kw), JRoster(pop, **kw)
    ids = sorted({0, pop - 1, pop // 2, pop // 3, max(0, pop - 7)})
    assert [r.cohort_of(i) for i in ids] == [j.cohort_of(i) for i in ids]
    for c in range(cohorts):
        assert r.cohort_range(c) == j.cohort_range(c)
        assert r._quota(c) == j._quota(c)
    assert r.sample_rate == j.sample_rate
    assert r.expected_participants == j.expected_participants
    for q in (0.01, 0.5, 0.9, 0.999):
        assert r.finish_quantile(q) == j.finish_quantile(q)
    assert r.barrier_compute_s() == j.barrier_compute_s()
    links = [(LinkModel(), JLinkModel()),
             (LinkModel(0.01, 1e8), JLinkModel(0.01, 1e8))]
    for nb in (0, 4_123_652):
        for hier in (False, True):
            for (up, jup), (down, jdown) in ((links[0], links[1]),
                                             (links[1], links[0])):
                kw_t = dict(down_bytes=nb // 3, uplink=up, downlink=down,
                            hierarchical=hier)
                kw_j = dict(down_bytes=nb // 3, uplink=jup, downlink=jdown,
                            hierarchical=hier)
                assert r.round_time_s(nb, **kw_t) == j.round_time_s(nb,
                                                                    **kw_j)
                assert r.rounds_per_second(nb, **kw_t) \
                    == j.rounds_per_second(nb, **kw_j)
            assert r.wan_bytes_per_round(nb, hierarchical=hier) \
                == j.wan_bytes_per_round(nb, hierarchical=hier)
    assert r.round_time_s(1000) == j.round_time_s(1000)
    for cid in [f"v{i}" for i in ids] + ["c3", "v", "vx1", 7]:
        assert r.cohort_of_cid(cid) == j.cohort_of_cid(cid)
    for sigma, rounds in ((1.1, 50), (0.8, 3)):
        assert abs(r.amplified_epsilon(sigma, rounds)
                   - j.amplified_epsilon(sigma, rounds)) < 1e-9


# ---------------------------------------------------------------------------
# sampling: the contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pop,m,cohorts,avail", GRID)
def test_sampling_is_pure_distinct_and_in_its_cohort(pop, m, cohorts,
                                                     avail):
    r = Roster(pop, participants=m, cohorts=cohorts, seed=5,
               availability=avail)
    s = r.sample_round(4)
    assert s == Roster(pop, participants=m, cohorts=cohorts, seed=5,
                       availability=avail).sample_round(4)
    assert s.num_participants == m == len(set(s.client_ids))
    for c in range(cohorts):
        lo, hi = r.cohort_range(c)
        members = s.by_cohort[c]
        assert len(members) == r._quota(c)
        assert all(lo <= i < hi and r.cohort_of(i) == c for i in members)
    if m < pop:                               # another round, other ids
        assert any(r.sample_round(k).client_ids != s.client_ids
                   for k in (5, 6))
    assert s.cohorts == tuple(r.cohort_of(i) for i in s.client_ids)


def test_rejection_branch_is_deterministic_and_distinct():
    key = keys.fold_in(keys.root(keys.ROSTER, 0), 3)
    a = _sample_indices(key, 10**12, 500)
    assert np.array_equal(a, _sample_indices(key, 10**12, 500))
    assert len(set(a.tolist())) == 500 and a.min() >= 0 and a.max() < 10**12
    assert not np.array_equal(a, _sample_indices(keys.fold_in(key, 1),
                                                 10**12, 500))
    # small populations draw without replacement: every index, once
    assert sorted(_sample_indices(key, 50, 50).tolist()) == list(range(50))
    assert _sample_indices(key, 10, 0).shape == (0,)


def test_billion_client_population_samples_in_well_under_a_second():
    r = Roster(10**9, participants=64, cohorts=8, seed=0)
    t0 = time.perf_counter()
    s = r.sample_round(0)
    assert time.perf_counter() - t0 < 0.5
    assert len(set(s.client_ids)) == 64


def test_compute_time_is_static_and_lognormal_around_the_median():
    r = Roster(10_000, participants=16, cohorts=4, seed=0)
    ts = [r.compute_time(i) for i in range(400)]
    assert ts == [r.compute_time(i) for i in range(400)]
    assert all(t > 0 for t in ts)
    z = np.log(np.asarray(ts) / r.compute_time_s) / r.compute_log_sigma
    assert abs(z.mean()) < 0.2 and 0.8 < z.std() < 1.2
    flat = Roster(100, participants=4, compute_log_sigma=0.0)
    assert flat.compute_time(3) == flat.compute_time_s


# ---------------------------------------------------------------------------
# the roster's cohorts drive the two-tier reduce
# ---------------------------------------------------------------------------

def _client_trees(ids, device="cpu"):
    shapes = {"conv": {"b": (8,), "w": (5, 5, 1, 8)}, "head": (33,)}
    out = {}
    for i, cid in enumerate(ids):
        rng = np.random.default_rng(i)
        out[cid] = {"conv": {k: torch.tensor(rng.standard_normal(s).astype(
            np.float32), device=device) for k, s in shapes["conv"].items()},
            "head": torch.tensor(rng.standard_normal(
                shapes["head"]).astype(np.float32), device=device)}
    return out


def _two_tier(roster, trees, weights, use_kernel):
    agg = HierarchicalAggregator(roster.cohorts, use_kernel=use_kernel,
                                 cohort_of=roster.cohort_of_cid)
    reds = agg.reduce_all({cid: (trees[cid], weights[cid]) for cid in trees})
    return reds, fedavg_trees([r.aggregate for r in reds],
                              [r.weight for r in reds])


def _flat(trees, weights):
    cids = list(trees)
    w = torch.tensor([weights[c] for c in cids], dtype=torch.float32)
    out = fedavg_leaves_ref([[l.cpu() for l in leaves(trees[c])]
                             for c in cids], w / w.sum())
    return unflatten_like(trees[cids[0]], out)


def test_cohort_of_cid_groups_like_jax_and_two_tier_equals_flat():
    kw = dict(participants=16, cohorts=4, seed=0)
    r, j = Roster(1_000_000, **kw), JRoster(1_000_000, **kw)
    ids = [f"v{i}" for i in r.sample_round(0).client_ids]
    # the same ids grouped by each package's roster, the same groups
    groups = assign_cohorts(ids, 4, r.cohort_of_cid)
    assert groups == jassign_cohorts(ids, 4, j.cohort_of_cid)
    assert sorted(groups) == [0, 1, 2, 3]
    assert all(len(g) == 4 for g in groups.values())
    trees = _client_trees(ids)
    weights = {cid: float(1 + i % 3) for i, cid in enumerate(ids)}
    reds, two_tier = _two_tier(r, trees, weights, use_kernel=False)
    assert [list(red.members) for red in reds] == [groups[c] for c in
                                                   range(4)]
    assert [red.weight for red in reds] == [
        sum(weights[m] for m in groups[c]) for c in range(4)]
    for a, b in zip(leaves(two_tier), leaves(_flat(trees, weights))):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_two_tier_reduce_through_the_kernel_on_gpu(cuda):
    from repro_torch.kernels.fedavg.kernel import fedavg_leaves_kernel
    r = Roster(1_000_000, participants=16, cohorts=4, seed=0)
    ids = [f"v{i}" for i in r.sample_round(0).client_ids]
    trees = _client_trees(ids, cuda)
    weights = {cid: float(1 + i % 3) for i, cid in enumerate(ids)}
    before = fedavg_leaves_kernel.launches
    _, two_tier = _two_tier(r, trees, weights, use_kernel=True)
    torch.cuda.synchronize()
    assert fedavg_leaves_kernel.launches - before == 5   # 4 cohorts + WAN
    for a, b in zip(leaves(two_tier), leaves(_flat(trees, weights))):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
