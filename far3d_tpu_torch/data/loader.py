"""Threaded host data loaders (counterpart of ``far3d_tpu/data/loader.py``;
reference: torch DataLoader worker processes + mmcv collate,
datasets/builder.py:23-118).

A pool of worker threads runs the host pipeline (the PNG decode's zlib and
the warp's torch ops release the interpreter lock) and a bounded queue
prefetches batches ahead of the step, so host work overlaps the card's.
Batches come out as dicts of stacked CPU tensors with the keys of the JAX
package's ``TrainBatch``, in page-locked memory when the consumer's device
is a CUDA device, so that ``.to(device, non_blocking=True)`` overlaps the
step. An error in a worker reaches the consumer at its next batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..config import Far3DConfig
from ..entry import resolve_device
from .av2_dataset import AV2SequenceDataset
from .pipeline import process_frame
from .sampler import EvalShardSampler, InfiniteGroupStreamSampler

BATCH_KEYS = ('images', 'lidar2img', 'intrinsics', 'extrinsics', 'timestamp',
              'prev_exists', 'ego_pose', 'ego_pose_inv')
TRAIN_KEYS = BATCH_KEYS + (
    'gt_boxes', 'gt_velocity', 'gt_labels', 'gt_mask', 'gt_boxes2d',
    'gt_labels2d', 'gt_centers2d', 'gt_mask2d', 'gt_depth_bins',
    'gt_depth_fg')


def _tensor(x, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory() if pin else t


def _stack_batch(frames, pin: bool) -> Dict[str, torch.Tensor]:
    return {k: _tensor(np.stack([f[k] for f in frames]), pin)
            for k in TRAIN_KEYS}


class TrainLoader:
    """Infinite stream-preserving training loader. `device` is the
    consumer's ('cuda' unless the caller asks for another): batches are
    pinned for a CUDA device."""

    def __init__(self, dataset: AV2SequenceDataset, cfg: Far3DConfig,
                 batch_size: int, rank: int = 0, world_size: int = 1,
                 seed: int = 0, prefetch: int = 4, num_threads: int = 8,
                 device=None):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self._pin = resolve_device(device).type == 'cuda'
        self.sampler = InfiniteGroupStreamSampler(
            dataset.flag, batch_size, rank, world_size, seed)
        self._rngs = [np.random.default_rng(seed * 7919 + rank * batch_size + i)
                      for i in range(batch_size)]
        self._queue: 'queue.Queue' = queue.Queue(maxsize=prefetch)
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _load_one(self, lane: int, idx: int) -> Dict:
        rec = self.dataset.get_frame(idx)
        return process_frame(rec, self.cfg, self._rngs[lane], train=True)

    def _producer(self):
        try:
            for indices in self.sampler:
                if self._stop.is_set():
                    return
                futs = [self._pool.submit(self._load_one, lane, idx)
                        for lane, idx in enumerate(indices)]
                frames = [f.result() for f in futs]
                self._queue.put(_stack_batch(frames, self._pin))
        except BaseException as e:      # handed to the consumer, re-raised
            self._queue.put(e)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            item = self._queue.get()
            if isinstance(item, BaseException):
                raise item
            yield item

    def stop(self):
        """Stop the producer (it ends at its next batch) and the pool."""
        self._stop.set()
        while True:                      # unblock a producer waiting to put
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._pool.shutdown(wait=False, cancel_futures=True)


class EvalLoader:
    """Sequential streaming eval loader for one rank's contiguous shard
    (reference: custom_multi_gpu_test, core/apis/test.py:45-113). Each
    frame is ``process_frame``'s dict with its arrays as CPU tensors (the
    model inputs pinned for a CUDA `device`) and its dataset ``index``."""

    def __init__(self, dataset: AV2SequenceDataset, cfg: Far3DConfig,
                 rank: int = 0, world_size: int = 1, prefetch: int = 8,
                 num_threads: int = 8, max_frames: Optional[int] = None,
                 device=None):
        self.dataset = dataset
        self.cfg = cfg
        self._pin = resolve_device(device).type == 'cuda'
        self.sampler = EvalShardSampler(len(dataset), rank, world_size)
        n = len(self.sampler)
        self._limit = n if max_frames is None else min(max_frames, n)
        # padded tail repeats only survive a cap that reaches into them
        self.pad = max(0, self.sampler.pad - (n - self._limit))
        self._prefetch = prefetch
        self._num_threads = num_threads

    def __len__(self):
        return self._limit

    def _load(self, idx: int) -> Dict:
        rec = self.dataset.get_frame(idx)
        out = process_frame(rec, self.cfg, np.random.default_rng(0),
                            train=False)
        for k, v in out.items():
            if isinstance(v, (np.ndarray, np.number)):
                out[k] = _tensor(v, self._pin and k in BATCH_KEYS)
        out['index'] = idx
        return out

    def __iter__(self):
        indices = list(self.sampler)[:self._limit]
        with ThreadPoolExecutor(max_workers=self._num_threads) as pool:
            futs = [pool.submit(self._load, i)
                    for i in indices[:self._prefetch]]
            k = len(futs)
            for i in range(len(indices)):
                frame = futs[i % self._prefetch].result()
                if k < len(indices):
                    futs[k % self._prefetch] = pool.submit(self._load,
                                                           indices[k])
                    k += 1
                yield frame
