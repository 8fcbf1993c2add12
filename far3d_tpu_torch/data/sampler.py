"""Stream-preserving samplers (a copy of ``far3d_tpu/data/sampler.py``;
reference datasets/samplers/group_sampler.py).

`InfiniteGroupStreamSampler` is the counterpart of the load-bearing
InfiniteGroupEachSampleInBatchSampler (group_sampler.py:153-236): every
(rank, batch-lane) pair owns a private infinite shuffled stream of scene
groups and consumes each group's frames in order, so the recurrent temporal
memory in FarHead stays valid per lane — lanes never hop between scenes
mid-stream, and `prev_exists` is 0 exactly at group starts.

`EvalShardSampler` mirrors the non-shuffled DistributedSampler
(distributed_sampler.py:15-46) + interval_test ordering: contiguous per-rank
shards so each rank streams temporally ordered frames, padded to equal length.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class InfiniteGroupStreamSampler:
    def __init__(self, group_flags: np.ndarray, batch_size: int,
                 rank: int = 0, world_size: int = 1, seed: int = 0):
        self.flags = np.asarray(group_flags)
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.groups = np.unique(self.flags)
        self.group_to_indices = {
            g: np.where(self.flags == g)[0] for g in self.groups}
        # private RNG + state per local lane; each lane cycles through
        # freshly shuffled permutations of all groups (group_sampler.py:210-214)
        self._rngs = [
            np.random.default_rng(seed + rank * batch_size + i)
            for i in range(batch_size)]
        self._perm: List[List[int]] = [[] for _ in range(batch_size)]
        self._cur: List[List[int]] = [[] for _ in range(batch_size)]

    def _refill(self, lane: int):
        if not self._perm[lane]:
            self._perm[lane] = list(self._rngs[lane].permutation(self.groups))
        g = self._perm[lane].pop(0)
        self._cur[lane] = list(self.group_to_indices[g])

    def __iter__(self) -> Iterator[List[int]]:
        while True:
            batch = []
            for lane in range(self.batch_size):
                if not self._cur[lane]:
                    self._refill(lane)
                batch.append(self._cur[lane].pop(0))
            yield batch


class EpochGroupSampler:
    """Epoch-based distributed group sampler (reference:
    group_sampler.py:21-116 DistributedGroupSampler) for EpochBasedRunner-
    style training — registered by the reference though its shipped config
    uses the infinite stream sampler above; provided for parity.

    Semantics per epoch (deterministic in ``seed + epoch``):
      1. shuffle indices *within* each scene group;
      2. pad every group to a multiple of ``batch_size * world_size`` by
         repeating its own (shuffled) indices, so each batch-chunk stays
         group-pure;
      3. shuffle the concatenated list at ``batch_size``-chunk granularity;
      4. each rank takes the contiguous shard ``[rank*n : (rank+1)*n]``.
    Every chunk of ``batch_size`` consecutive indices on a rank therefore
    comes from a single group, and all ranks see the identical permutation.
    """

    def __init__(self, group_flags: np.ndarray, batch_size: int,
                 rank: int = 0, world_size: int = 1, seed: int = 0):
        self.flags = np.asarray(group_flags)
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0
        self.group_sizes = np.bincount(self.flags)
        per = batch_size * world_size
        self.num_samples = sum(
            int(-(-int(sz) // per)) * batch_size
            for sz in self.group_sizes if sz > 0)
        self.total_size = self.num_samples * world_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        per = self.batch_size * self.world_size
        indices: List[int] = []
        for g, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            idx = list(rng.permutation(np.where(self.flags == g)[0]))
            target = int(-(-len(idx) // per)) * per
            base = idx.copy()
            while len(idx) < target:
                idx.extend(base[:target - len(idx)])
            indices.extend(idx)
        assert len(indices) == self.total_size
        chunks = np.asarray(indices).reshape(-1, self.batch_size)
        chunks = chunks[rng.permutation(len(chunks))]
        flat = chunks.reshape(-1)
        off = self.num_samples * self.rank
        return iter(flat[off:off + self.num_samples].tolist())

    def __len__(self) -> int:
        return self.num_samples


class EvalShardSampler:
    """Contiguous per-rank eval shards, padded to a common length by repeating
    the last index (padding results are dropped at collection, matching
    DistributedSampler's round-up, distributed_sampler.py:30-46)."""

    def __init__(self, n: int, rank: int = 0, world_size: int = 1):
        per = -(-n // world_size)
        start = rank * per
        idx = list(range(start, min(start + per, n)))
        self.pad = per - len(idx)
        idx = idx + [n - 1] * self.pad
        self.indices = idx

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)
