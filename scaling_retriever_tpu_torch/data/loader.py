"""A minimal deterministic data loader with rank sharding (port of
data/loader.py): map-style dataset in, collated batches out; strided
sharding follows ``DistributedSampler(shuffle=False)``, contiguous
sharding splits the index range."""

from __future__ import annotations

import random
from typing import Callable, Iterator, Sequence


class DataLoader:
    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False,
                 rank: int = 0, world_size: int = 1,
                 strided_shard: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.rank = rank
        self.world_size = world_size
        self.strided_shard = strided_shard
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> Sequence[int]:
        n = len(self.dataset)
        idx = list(range(n))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        if self.world_size > 1:
            if self.strided_shard:
                idx = idx[self.rank::self.world_size]
            else:
                per = -(-n // self.world_size)
                idx = idx[self.rank * per:(self.rank + 1) * per]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator:
        idx = self._indices()
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[i] for i in chunk])
