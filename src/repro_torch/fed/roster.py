"""Lazy client roster: 10k-1M clients priced per round, never materialized.
Port of ``repro/fed/roster.py``.

The engine's :class:`~repro_torch.fed.engine.ClientSpec` list is the
*materialized* roster — fine for a handful of simulated clients,
impossible at the paper's "many user devices" scale.  A :class:`Roster`
represents the whole population by three things only:

  * **deterministic sampling** — each round's participants are drawn under
    a ``(round, cohort)`` key chain, so resampling any round is
    reproducible across processes and devices without storing a single
    per-client record.  Per-client keys extend the chain with the client id
    (``client_key``) — the noise / availability stream of client ``i`` in
    round ``r`` is a pure function of ``(seed, r, cohort, i)``.
  * **amplified privacy accounting** — sampling ``m`` of ``n`` clients per
    round is subsampling at rate ``q = m/n``; the roster wires ``q`` into
    the subsampled-RDP accountant (``privacy/defenses``) so population
    growth buys epsilon down analytically.
  * **analytic pricing** — availability and finish-time distributions are
    closed-form (Bernoulli thinning; lognormal compute times with the sync
    barrier at the max-order statistic quantile), so rounds-per-second vs
    population is a formula, not a simulation over a million specs.

Cohorts are contiguous index ranges (``population / cohorts`` clients per
edge aggregator); :meth:`Roster.cohort_of_cid` hands that grouping to
:class:`~repro_torch.fed.hierarchy.HierarchicalAggregator` (``cohort_of``),
so participants of cohort ``c`` pre-reduce at edge ``c`` before the WAN.

The reference's keys are ``jax.random`` keys, whose streams PyTorch cannot
reproduce; the port's are :mod:`repro_torch.keys` paths
``(ROSTER, seed, round, cohort[, client])`` and its draws come from numpy's
PCG64 seeded by :func:`repro_torch.keys.seed_of`.  So the sampled ids
differ from the reference's while the contract is the same; every
closed-form quantity equals the reference's exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import keys
from repro_torch.fed.transport import LinkModel
from repro_torch.privacy.defenses import RDPAccountant, dp_epsilon

__all__ = ["Roster", "RoundSample"]

# fold_in salt separating the static per-client stream (compute times)
# from the per-round sampling chain — both hang off the same seed key
_STATIC_SALT = 0x5eed


def _rng(key: keys.Key) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(keys.seed_of(key)))


def _sample_indices(key: keys.Key, n: int, k: int) -> np.ndarray:
    """``k`` distinct indices in ``[0, n)``, deterministic in ``(key, n,
    k)``.  Small ``n`` (or ``k`` a quarter of ``n`` or more) draws without
    replacement; for huge populations a deterministic rejection loop draws
    batches of ints under ``fold_in(key, attempt)`` and keeps the first
    ``k`` distinct values in draw order — O(k) work and memory,
    independent of ``n``."""
    k = min(int(k), int(n))
    if k <= 0:
        return np.empty((0,), np.int64)
    if n <= (1 << 13) or 4 * k >= n:
        return _rng(key).choice(n, k, replace=False).astype(np.int64)
    out: List[int] = []
    seen: set = set()
    attempt = 0
    while len(out) < k:
        draw = _rng(keys.fold_in(key, attempt)).integers(0, n, 2 * k,
                                                         dtype=np.int64)
        for v in draw.tolist():
            if v not in seen:
                seen.add(v)
                out.append(v)
                if len(out) == k:
                    break
        attempt += 1
    return np.asarray(out, np.int64)


@dataclass(frozen=True)
class RoundSample:
    """One round's sampled participants (the only materialized clients)."""
    round_index: int
    client_ids: Tuple[int, ...]            # global indices into [0, pop)
    cohorts: Tuple[int, ...]               # cohort per participant
    by_cohort: Dict[int, Tuple[int, ...]] = field(default_factory=dict)

    @property
    def num_participants(self) -> int:
        return len(self.client_ids)


class Roster:
    """A population of ``population`` clients sampled ``participants`` per
    round, split into ``cohorts`` contiguous edge cohorts."""

    def __init__(self, population: int, *, participants: int,
                 cohorts: int = 1, seed: int = 0,
                 availability: float = 1.0,
                 compute_time_s: float = 30.0,
                 compute_log_sigma: float = 0.35):
        if population < 1:
            raise ValueError(f"population must be >= 1, got {population}")
        if not 1 <= participants <= population:
            raise ValueError(
                f"participants must be in [1, population={population}], "
                f"got {participants}")
        if not 1 <= cohorts <= participants:
            raise ValueError(
                f"cohorts must be in [1, participants={participants}], "
                f"got {cohorts}")
        if not 0.0 < availability <= 1.0:
            raise ValueError(
                f"availability must be in (0, 1], got {availability}")
        self.population = int(population)
        self.participants = int(participants)
        self.cohorts = int(cohorts)
        self.seed = int(seed)
        self.availability = float(availability)
        # lognormal finish-time model: median compute_time_s, shape
        # compute_log_sigma (0 = deterministic clients)
        self.compute_time_s = float(compute_time_s)
        self.compute_log_sigma = float(compute_log_sigma)
        self._base_key = keys.root(keys.ROSTER, self.seed)
        # contiguous cohort ranges: cohort c owns [c*span, min((c+1)*span, n))
        self._span = -(-self.population // self.cohorts)   # ceil div

    # ------------------------------------------------------------------
    # deterministic key chain: (round, cohort, client_id)
    # ------------------------------------------------------------------
    def round_key(self, round_index: int) -> keys.Key:
        return keys.fold_in(self._base_key, int(round_index))

    def cohort_key(self, round_index: int, cohort: int) -> keys.Key:
        return keys.fold_in(self.round_key(round_index), int(cohort))

    def client_key(self, round_index: int, cohort: int,
                   client_id: int) -> keys.Key:
        """The per-(round, cohort, client) key noise and availability
        draws derive from — the roster's whole RNG contract."""
        return keys.fold_in(self.cohort_key(round_index, cohort),
                            int(client_id))

    def cohort_of(self, client_id: int) -> int:
        return int(client_id) // self._span

    def cohort_range(self, cohort: int) -> Tuple[int, int]:
        lo = int(cohort) * self._span
        return lo, min(lo + self._span, self.population)

    # ------------------------------------------------------------------
    # per-round participant sampling
    # ------------------------------------------------------------------
    def _quota(self, cohort: int) -> int:
        """Participants drawn from this cohort: ``participants`` split as
        evenly as the cohort count allows (earlier cohorts take the
        remainder), capped by the cohort's size."""
        base, rem = divmod(self.participants, self.cohorts)
        want = base + (1 if cohort < rem else 0)
        lo, hi = self.cohort_range(cohort)
        return min(want, hi - lo)

    def sample_round(self, round_index: int) -> RoundSample:
        """The round's participants: per cohort, ``quota`` distinct clients
        drawn under the ``(round, cohort)`` key.  Pure — sampling the same
        round twice (any process, any device) returns the same clients."""
        ids: List[int] = []
        cohorts: List[int] = []
        by_cohort: Dict[int, Tuple[int, ...]] = {}
        for c in range(self.cohorts):
            lo, hi = self.cohort_range(c)
            local = _sample_indices(
                self.cohort_key(round_index, c), hi - lo, self._quota(c))
            members = tuple(int(lo + i) for i in local)
            by_cohort[c] = members
            ids.extend(members)
            cohorts.extend([c] * len(members))
        return RoundSample(int(round_index), tuple(ids), tuple(cohorts),
                           by_cohort)

    # ------------------------------------------------------------------
    # privacy: subsampling amplification
    # ------------------------------------------------------------------
    @property
    def sample_rate(self) -> float:
        """Per-round participation fraction q = m/n — the subsampled-RDP
        accountant's amplification rate.  (The per-cohort draw is without
        replacement; Poisson-q is the standard, slightly conservative
        model for it at q << 1.)"""
        return self.participants / self.population

    def accountant(self, noise_multiplier: float) -> RDPAccountant:
        """A subsampled-RDP accountant at this roster's q — epsilon per
        round shrinks as the population grows at fixed participants."""
        return RDPAccountant(noise_multiplier, sample_rate=self.sample_rate)

    def amplified_epsilon(self, noise_multiplier: float, rounds: int,
                          delta: float = 1e-5) -> float:
        return dp_epsilon(noise_multiplier, self.sample_rate, int(rounds),
                          delta)

    # ------------------------------------------------------------------
    # analytic availability / finish-time pricing
    # ------------------------------------------------------------------
    @property
    def expected_participants(self) -> float:
        """Bernoulli availability thins the sampled set: E = m * p."""
        return self.participants * self.availability

    def compute_time(self, client_id: int) -> float:
        """Client ``i``'s persistent compute time: a lognormal draw under
        the static (round-independent) chain — the same client is fast or
        slow in every round, deterministically."""
        k = keys.fold_in(self._base_key, _STATIC_SALT, int(client_id))
        z = float(_rng(k).standard_normal())
        return self.compute_time_s * math.exp(self.compute_log_sigma * z)

    def finish_quantile(self, q: float) -> float:
        """Inverse CDF of one client's compute time (lognormal)."""
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        z = NormalDist().inv_cdf(q)
        return self.compute_time_s * math.exp(self.compute_log_sigma * z)

    def barrier_compute_s(self) -> float:
        """The sync barrier waits for the slowest available participant:
        E[max of m iid draws] at the standard ``m/(m+1)`` order-statistic
        quantile — closed form, no per-client simulation."""
        m = max(1.0, self.expected_participants)
        return self.finish_quantile(m / (m + 1.0))

    def round_time_s(self, update_bytes: int, *, down_bytes: int = 0,
                     uplink: Optional[LinkModel] = None,
                     downlink: Optional[LinkModel] = None,
                     edge_uplink: Optional[LinkModel] = None,
                     hierarchical: bool = False) -> float:
        """One sync round's virtual wall time: downlink + the barrier
        compute quantile + the uplink hop(s).  Hierarchical rounds uplink
        ``update_bytes`` to the edge and one pre-reduced aggregate per
        cohort across the WAN (cohort fan-in never serializes per client —
        edges forward one tree each, concurrently)."""
        up = uplink or LinkModel()
        down = downlink or LinkModel()
        t = down.transfer_time(int(down_bytes)) + self.barrier_compute_s()
        if hierarchical:
            edge = edge_uplink or LinkModel(0.005, 200e6)
            return (t + edge.transfer_time(int(update_bytes))
                    + up.transfer_time(int(update_bytes)))
        return t + up.transfer_time(int(update_bytes))

    def rounds_per_second(self, update_bytes: int, **kw) -> float:
        return 1.0 / max(self.round_time_s(update_bytes, **kw), 1e-12)

    def wan_bytes_per_round(self, update_bytes: int, *,
                            hierarchical: bool = False) -> int:
        """Expected uplink bytes crossing the WAN per round: every
        available participant under flat FedAvg, one pre-reduced tree per
        cohort under the two-tier hierarchy — the fan-in cut
        (participants / cohorts)."""
        if hierarchical:
            return int(self.cohorts * int(update_bytes))
        return int(round(self.expected_participants)) * int(update_bytes)

    # ------------------------------------------------------------------
    # engine glue: materialize ONLY the sampled participants
    # ------------------------------------------------------------------
    def specs_for_round(self, round_index: int, *, weight: float = 1.0,
                        local_steps: int = 0) -> List:
        """ClientSpecs for this round's sample — the engine sees ``m``
        clients, never the population.  Ids are ``v<global index>`` so
        cohort membership survives the string round-trip
        (:meth:`cohort_of_cid`)."""
        from repro_torch.fed.engine import ClientSpec
        return [ClientSpec(f"v{i}", float(weight), self.compute_time(i),
                           local_steps=int(local_steps))
                for i in self.sample_round(round_index).client_ids]

    def cohort_of_cid(self, cid: str) -> int:
        """Cohort of a ``v<idx>`` client id (0 for foreign ids)."""
        if isinstance(cid, str) and cid[:1] == "v" and cid[1:].isdigit():
            return self.cohort_of(int(cid[1:]))
        return 0
