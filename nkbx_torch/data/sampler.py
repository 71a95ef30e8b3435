"""Samplers (counterpart of ``nkbx/data/sampler.py``): sequential, shuffle
and class-balanced, each a pure function of (seed, epoch), so that a
resumed epoch draws what the interrupted one drew.

``ImbalancedDatasetSampler`` weights each sample by 1 / count(its class) and
draws ``num_samples`` with replacement; multi-task labels weight by the
joint label tuple.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Sampler:
    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.seed = seed

    def __len__(self):
        return self.n

    def indices(self, epoch: int = 0) -> np.ndarray:
        raise NotImplementedError


class SequentialSampler(Sampler):
    def indices(self, epoch: int = 0) -> np.ndarray:
        return np.arange(self.n)


class ShuffleSampler(Sampler):
    def indices(self, epoch: int = 0) -> np.ndarray:
        return np.random.default_rng((self.seed, epoch)).permutation(self.n)


class ImbalancedDatasetSampler(Sampler):
    """Weighted multinomial with replacement over inverse class frequency."""

    def __init__(self, dataset=None, labels=None, num_samples: Optional[int] = None,
                 seed: int = 0):
        if labels is None:
            labels = dataset.get_labels()
        labels = np.asarray(labels)
        if labels.ndim > 1:  # multi-task: weight by the joint label tuple
            labels = np.asarray([str(tuple(row)) for row in labels])
        _, inverse, counts = np.unique(labels, return_inverse=True, return_counts=True)
        self.weights = 1.0 / counts[inverse]
        super().__init__(num_samples if num_samples is not None else len(labels), seed)
        self.p = self.weights / self.weights.sum()

    def indices(self, epoch: int = 0) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch, 17))
        return rng.choice(len(self.p), size=self.n, replace=True, p=self.p)
