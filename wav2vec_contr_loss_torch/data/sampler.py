"""Epoch-seeded balanced batch sampling.

The port's copy of wav2vec_contr_loss_tpu/data/sampler.py; it gives the
same index arrays for every (seed, epoch, rank, world_size, mode):
  * exactly batch_size/2 bonafide + batch_size/2 spoof indices per batch,
  * batches per epoch limited by the rarer class:
    num_batches = min(|real| // per_class, |fake| // per_class),
  * a per-epoch reshuffle seeded by (seed + epoch), then an in-batch
    shuffle, so a resumed run reproduces the exact batch stream.

'global' mode yields every global batch on every rank (the caller slices
its share); 'stride' gives batch b to rank b % world_size only, as the
reference's data-parallel path does.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

__all__ = ["BalancedBatchSampler"]


class BalancedBatchSampler:
    def __init__(
        self,
        labels: Sequence[int],
        batch_size: int,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        mode: str = "global",  # 'global' | 'stride'
    ):
        if batch_size % 2 != 0:
            raise ValueError("batch_size must be even for balanced batches")
        if mode not in ("global", "stride"):
            raise ValueError(f"unknown sampler mode: {mode}")
        labels = np.asarray(labels).astype(np.int64)
        self.real = np.nonzero(labels == 1)[0]
        self.fake = np.nonzero(labels == 0)[0]
        self.batch_size = batch_size
        self.per_class = batch_size // 2
        self.num_batches = int(
            min(self.real.size // self.per_class, self.fake.size // self.per_class)
        )
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.mode = mode
        if mode == "global" and batch_size % (2 * world_size) != 0:
            raise ValueError(
                "global mode needs batch_size divisible by 2*world_size"
            )

    def __len__(self) -> int:
        if self.mode == "stride":
            # batches this rank yields under round-robin striding
            return (self.num_batches - self.rank + self.world_size - 1) // self.world_size
        return self.num_batches

    def epoch_batches(self, epoch: int) -> Iterator[np.ndarray]:
        """Index arrays of one epoch."""
        rng = np.random.default_rng(np.random.PCG64(self.seed + epoch))
        real = self.real[rng.permutation(self.real.size)]
        fake = self.fake[rng.permutation(self.fake.size)]
        pc = self.per_class
        for b in range(self.num_batches):
            idx = np.concatenate([real[b * pc:(b + 1) * pc], fake[b * pc:(b + 1) * pc]])
            idx = idx[rng.permutation(idx.size)]
            if self.mode == "stride":
                if b % self.world_size == self.rank:
                    yield idx
            else:
                yield idx

    def epoch_index_matrix(self, epoch: int) -> np.ndarray:
        """(num_batches, batch_size) int array of one epoch's batches."""
        batches: List[np.ndarray] = list(self.epoch_batches(epoch))
        if not batches:
            return np.zeros((0, self.batch_size), np.int64)
        return np.stack(batches)
