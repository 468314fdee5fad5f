"""Minimal deterministic batch iterator with epoch shuffling.  Port of
``repro/data/pipeline.py``: pure numpy, so the same seed gives the same
batches, element for element, as the JAX package's."""
from __future__ import annotations

from typing import Iterator

import numpy as np


class BatchIterator:
    """Iterate (optionally dict-of-arrays) data in shuffled minibatches."""

    def __init__(self, data, batch_size: int, seed: int = 0,
                 drop_last: bool = True):
        self.data = data
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self._n = (len(next(iter(data.values()))) if isinstance(data, dict)
                   else len(data))

    def __len__(self) -> int:
        return self._n // self.batch_size if self.drop_last else \
            -(-self._n // self.batch_size)

    def epoch(self) -> Iterator:
        idx = self.rng.permutation(self._n)
        stop = self._n - (self._n % self.batch_size if self.drop_last else 0)
        for s in range(0, stop, self.batch_size):
            sel = idx[s:s + self.batch_size]
            if isinstance(self.data, dict):
                yield {k: v[sel] for k, v in self.data.items()}
            else:
                yield self.data[sel]
