"""Two-tier hierarchical aggregation: edge cohorts pre-reduce before the
WAN.  Port of ``repro/fed/hierarchy.py``.

Flat FedAvg uplinks every client's update across the WAN, so WAN bytes grow
with the participant count.  The two-tier topology puts edge aggregators in
between: each cohort of clients uplinks over a cheap edge hop, the edge
pre-reduces the cohort's updates with the weighted mean the server would
apply (through the fedavg CUDA kernel under ``fed.kernel_aggregation``),
and only ONE tree per cohort crosses the WAN.  With cohort weights equal to
the member weight sums, the weighted mean of weighted means is the flat
aggregate, up to float reassociation (so the engine's comparison with the
flat round is at a tolerance).

The engine owns virtual time and byte accounting; this module only groups
clients and reduces a cohort.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.fed.aggregate import StreamingAggregator
from repro_torch.fed.programs import fedavg_stacked, stack_trees
from repro_torch.kernels.fedavg.ops import fedavg_trees, normalised_weights
from repro_torch.tree import leaves

__all__ = ["CohortReduction", "HierarchicalAggregator", "assign_cohorts"]


def assign_cohorts(client_ids: Sequence[str], num_cohorts: int,
                   cohort_of: Optional[Callable[[str], int]] = None
                   ) -> Dict[int, List[str]]:
    """Group client ids into cohorts.

    With ``cohort_of`` membership follows it (modulo ``num_cohorts``);
    otherwise the ids are cut into ``num_cohorts`` contiguous, balanced
    slices in schedule order."""
    n = max(1, int(num_cohorts))
    out: Dict[int, List[str]] = {}
    if cohort_of is not None:
        for cid in client_ids:
            out.setdefault(int(cohort_of(cid)) % n, []).append(cid)
        return out
    ids = list(client_ids)
    span = -(-len(ids) // n) if ids else 1
    for i, cid in enumerate(ids):
        out.setdefault(i // span, []).append(cid)
    return out


@dataclass(frozen=True)
class CohortReduction:
    """One edge's pre-reduced contribution to the WAN hop."""
    cohort: int
    aggregate: object            # weighted-mean tree over the cohort
    weight: float                # sum of member weights (server-side weight)
    members: Tuple[str, ...]     # client ids reduced into the aggregate


class HierarchicalAggregator:
    """Edge-tier reducer: weighted FedAvg over each cohort's updates.

    ``use_kernel`` is the engine's ``fed.kernel_aggregation``: the decode
    pre-reduce goes through the fedavg kernel (one launch a cohort over
    the members' trees where they lie), the streaming one through the
    agg_fuse kernels, as the server reduce they replace would."""

    def __init__(self, num_cohorts: int, *, use_kernel: bool = False,
                 cohort_of: Optional[Callable[[str], int]] = None):
        if num_cohorts < 1:
            raise ValueError(f"num_cohorts must be >= 1, got {num_cohorts}")
        self.num_cohorts = int(num_cohorts)
        self.use_kernel = bool(use_kernel)
        self.cohort_of = cohort_of

    def group(self, client_ids: Sequence[str]) -> Dict[int, List[str]]:
        return assign_cohorts(client_ids, self.num_cohorts, self.cohort_of)

    def reduce_cohort(self, cohort: int, members: Sequence[str],
                      trees: Sequence, weights: Sequence[float]
                      ) -> CohortReduction:
        """Pre-reduce one cohort: the weighted mean of its members' trees,
        with the sum of member weights as its weight."""
        if not trees:
            raise ValueError(f"cohort {cohort} has no member updates")
        if self.use_kernel:
            # the members' trees read in place, one launch a cohort; the
            # weights normalised twice, as fedavg_stacked's kernel form does
            agg = fedavg_trees(list(trees), normalised_weights(
                weights, leaves(trees[0])[0].device))
        else:
            agg = fedavg_stacked(stack_trees(list(trees)), list(weights))
        return CohortReduction(int(cohort), agg, float(sum(weights)),
                               tuple(members))

    def reduce_all(self, updates: Dict[str, Tuple[object, float]]
                   ) -> List[CohortReduction]:
        """Reduce a round: ``updates`` maps client id -> (decoded tree,
        weight); one reduction per non-empty cohort, in cohort order."""
        grouped = self.group(list(updates))
        return [self.reduce_cohort(c, grouped[c],
                                   [updates[m][0] for m in grouped[c]],
                                   [updates[m][1] for m in grouped[c]])
                for c in sorted(grouped)]

    def reduce_all_streaming(self, updates: Dict[str, Tuple[object, float]],
                             template, *, codec_name: str
                             ) -> List[CohortReduction]:
        """Compressed-domain round reduce: ``updates`` maps client id ->
        (``Codec.encode_tree`` payload, weight).  Each cohort folds its
        members' WIRE payloads through one :class:`StreamingAggregator`, so
        the edge never stacks decoded member trees.  ``aggregate`` is the
        cohort's weighted mean in the wire's domain (the delta domain for
        lossy codecs: the engine rebases it onto the global tree)."""
        grouped = self.group(list(updates))
        out: List[CohortReduction] = []
        for c in sorted(grouped):
            agg = StreamingAggregator(codec_name, use_kernel=self.use_kernel)
            agg.init(template)
            for m in grouped[c]:
                enc, w = updates[m]
                agg.fold(enc, w)
            out.append(CohortReduction(int(c), agg.finalize(),
                                       float(agg.wsum), tuple(grouped[c])))
        return out
