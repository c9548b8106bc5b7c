"""The iteration sampler (``vmg_tpu/data/sampler.py``; reference
``data/data_sampler.py:11-106``): the epoch enlarged by ``ratio``
(dataset_expand_ratio), an epoch-seeded permutation taken modulo the
dataset size, and each replica's strided share."""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np


class IterSampler:
    def __init__(self, dataset_size: int, num_replicas: int = 1, rank: int = 0,
                 ratio: int = 1, seed: int = 0):
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.seed = seed
        self.num_samples = int(math.ceil(dataset_size * ratio / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        indices = rng.permutation(self.total_size) % self.dataset_size
        indices = indices[self.rank: self.total_size: self.num_replicas]
        assert len(indices) == self.num_samples
        return iter(indices.tolist())

    def __len__(self) -> int:
        return self.num_samples
