"""Batching and host-to-device prefetch: counterpart of
`articulated_pose_tpu/data/batcher.py`.

`BatchIterator` (an epoch iterator over an in-memory sample cache) and
`StreamingIterator` (freshly generated batches) are NumPy copies that
give the same order for a seed.  `device_prefetch` copies batches from
pinned host buffers to the card on a side CUDA stream, `size` batches
ahead, so the copy of batch k+1 overlaps the step on batch k.
"""

from __future__ import annotations

import collections
import itertools
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch


class BatchIterator:
    """Epoch iterator over an in-memory sample cache.

    `fetch(i)` produces sample dicts lazily on the first epoch (mirroring
    the reference's data_matrix cache, lib/dataset.py:109-155); later
    epochs permute the cached matrix in place.
    """

    def __init__(self, n_data: int, fetch: Callable[[int], Dict[str, np.ndarray]],
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True,
                 transform: Optional[Callable] = None):
        self.n_data = n_data
        self.fetch = fetch
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        # transform(batch, rng) applied per yielded batch, AFTER the
        # cache — augmentation stays fresh every epoch (data/augment.py)
        self.transform = transform
        self._rng = np.random.RandomState(seed)
        self._cache: Optional[Dict[str, np.ndarray]] = None

    def _ensure_cache(self):
        if self._cache is not None:
            return
        first = self.fetch(0)
        cache = {k: np.zeros((self.n_data,) + v.shape, v.dtype)
                 for k, v in first.items()}
        for k, v in first.items():
            cache[k][0] = v
        for i in range(1, self.n_data):
            s = self.fetch(i)
            for k, v in s.items():
                cache[k][i] = v
        self._cache = cache

    def __len__(self):
        if self.drop_last:
            return self.n_data // self.batch_size
        return -(-self.n_data // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._ensure_cache()
        order = (self._rng.permutation(self.n_data) if self.shuffle
                 else np.arange(self.n_data))
        stop = (self.n_data - self.n_data % self.batch_size
                if self.drop_last else self.n_data)
        for lo in range(0, stop, self.batch_size):
            sel = order[lo:lo + self.batch_size]
            batch = {k: v[sel] for k, v in self._cache.items()}
            yield (self.transform(batch, self._rng)
                   if self.transform else batch)


class StreamingIterator:
    """Infinite stream of freshly generated batches.

    Each epoch-sized pass yields `batches_per_epoch` batches built by
    `make_sample(rng)` — no cache, so synthetic training never sees the
    same frame twice (removes the fixed-epoch overfitting of the cached
    BatchIterator for procedural data).
    """

    def __init__(self, make_sample, batch_size: int,
                 batches_per_epoch: int = 50, seed: int = 0):
        self.make_sample = make_sample
        self.batch_size = batch_size
        self.batches_per_epoch = batches_per_epoch
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return self.batches_per_epoch

    def __iter__(self):
        for _ in range(self.batches_per_epoch):
            samples = [self.make_sample(self._rng)
                       for _ in range(self.batch_size)]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def device_prefetch(iterator, size: int = 2, device="cuda",
                    stream: Optional[torch.cuda.Stream] = None):
    """Batches of `iterator` (dicts of numpy arrays) as dicts of tensors
    on `device`, in order, copied `size` batches ahead.

    On the card each batch is staged in pinned host memory and copied
    non-blocking on a side stream (`stream`, a new one by default); an
    event recorded after its copies is what the consuming stream waits
    on before it gets the batch (a wait_stream on the copy stream would
    also wait for the copies of the batches behind it), and each tensor
    is marked with `record_stream` for the consuming stream, so the
    allocator does not hand its memory to another tensor while that
    stream still reads it.  Without those two, a step could read a
    half-copied batch.  On the CPU the batches are the arrays as
    tensors.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.as_tensor(np.asarray(v), device=device)
                   for k, v in batch.items()}
        return
    copy_stream = stream or torch.cuda.Stream(device)
    queue = collections.deque()

    def put(batch):
        with torch.cuda.stream(copy_stream):
            out = {k: torch.as_tensor(np.ascontiguousarray(v)).pin_memory()
                   .to(device, non_blocking=True) for k, v in batch.items()}
            copied = torch.cuda.Event()
            copied.record(copy_stream)
        queue.append((out, copied))

    it = iter(iterator)
    for b in itertools.islice(it, size):
        put(b)
    while queue:
        out, copied = queue.popleft()
        stream = torch.cuda.current_stream(device)
        stream.wait_event(copied)
        for t in out.values():
            t.record_stream(stream)
        try:
            put(next(it))
        except StopIteration:
            pass
        yield out
