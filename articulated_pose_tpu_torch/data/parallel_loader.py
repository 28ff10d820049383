"""Threaded host-side loader: parallel fetch + label over the C++ core; a
copy of `articulated_pose_tpu/data/parallel_loader.py`, whose batches
equal `data.batcher.BatchIterator`'s for the same seed.

The reference fed its graph from a single-threaded feed_dict producer
(reference: lib/network.py:331-338); keeping an accelerator fed at
hundreds of thousands of clouds/sec needs a parallel host pipeline.
This loader fans sample construction out over a thread pool — effective
because the hot labeling math runs in the native C++ library (ctypes
releases the GIL for the call's duration) and h5py I/O also drops the
GIL — and overlaps batch assembly with device compute via the
device_prefetch copy stream (data/batcher.py).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np


class ParallelLoader:
    """Iterator producing batched sample dicts with a worker pool.

    fetch(i) -> sample dict (thread-safe; e.g. HDF5Dataset.fetch with
    per-call file handles, or a SyntheticArticulated frame via the
    native labeling path).
    """

    def __init__(self, n_data: int, fetch: Callable[[int], Dict[str, np.ndarray]],
                 batch_size: int, *, shuffle: bool = True, seed: int = 0,
                 num_workers: Optional[int] = None, drop_last: bool = True,
                 prefetch_batches: int = 2,
                 transform: Optional[Callable] = None):
        self.n_data = n_data
        self.fetch = fetch
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        # same per-batch hook as BatchIterator.transform (one policy)
        self.transform = transform
        self._rng = np.random.RandomState(seed)
        self.num_workers = num_workers or min(8, (os.cpu_count() or 4))

    def __len__(self):
        if self.drop_last:
            return self.n_data // self.batch_size
        return -(-self.n_data // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = (self._rng.permutation(self.n_data) if self.shuffle
                 else np.arange(self.n_data))
        stop = (self.n_data - self.n_data % self.batch_size
                if self.drop_last else self.n_data)
        batches = [order[lo:lo + self.batch_size]
                   for lo in range(0, stop, self.batch_size)]

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            # pipeline: keep `prefetch_batches` batches in flight
            pending = []
            bi = 0

            def submit(idx_batch):
                return [pool.submit(self.fetch, int(i)) for i in idx_batch]

            while bi < len(batches) and len(pending) < self.prefetch_batches:
                pending.append(submit(batches[bi]))
                bi += 1
            while pending:
                futs = pending.pop(0)
                if bi < len(batches):
                    pending.append(submit(batches[bi]))
                    bi += 1
                samples = [f.result() for f in futs]
                batch = {k: np.stack([s[k] for s in samples])
                         for k in samples[0]}
                yield (self.transform(batch, self._rng)
                       if self.transform else batch)
