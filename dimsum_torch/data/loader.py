"""Threaded loader and the copy to the card, port of
`dimsum_tpu/data/loader.py`.

`Loader` is the JAX `Loader` (:19-101): the same epoch shuffle
(`np.random.default_rng(seed * 100_003 + epoch)`), the same contiguous
stripe a shard after the shuffle (the reference's DistributedSampler
contract), the same `drop_last` and the same pool of worker threads that
assemble numpy batches (through the dataset's `gather` where it has one).
Two loaders on the same file give the same batches bit for bit.  Two
differences, neither in what is yielded: the JAX workers run ahead without
bound (an epoch of batches can pile up in host memory), and a worker's
exception leaves the JAX consumer waiting forever; here the workers stay
at most `prefetch` batches ahead of the consumer, and a worker's
exception is raised in the consumer.

`device_batches` replaces `device_put_sharded_batch`: each batch is copied
to the device from pinned host memory with `non_blocking=True` on a side
stream, one batch ahead, so that the next batch's copy overlaps the step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch


class Loader:
    """Shuffling epoch-based loader yielding (x, y) numpy batches.

    shard_id / num_shards: each process of a data-parallel run loads only
    its stripe of the epoch's shuffled indices."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 shard_id: int = 0, num_shards: int = 1,
                 num_workers: int = 4, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 100_003 + self.epoch)
            rng.shuffle(idx)
        # contiguous stripes after the shuffle, one a shard
        per = n // self.num_shards
        idx = idx[self.shard_id * per: (self.shard_id + 1) * per]
        if self.drop_last:
            nb = len(idx) // self.batch_size
            idx = idx[: nb * self.batch_size]
        return idx

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _assemble(self, b):
        if hasattr(self.dataset, "gather"):
            return self.dataset.gather(b)
        xs, ys = zip(*(self.dataset[int(j)] for j in b))
        return np.stack(xs), np.asarray(ys, np.int64)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._epoch_indices()
        batches = [idx[i: i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        jobs: "queue.Queue" = queue.Queue()
        for job in enumerate(batches):
            jobs.put(job)
        results, cv = {}, threading.Condition()
        # a slot is held from before a job is taken until its batch is
        # consumed: at most `prefetch` batches wait beyond those assembling
        slots = threading.Semaphore(self.prefetch + self.num_workers)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                if not slots.acquire(timeout=0.1):
                    continue
                try:
                    i, b = jobs.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    batch = self._assemble(b)
                except Exception as e:  # raised in the consumer
                    batch = e
                with cv:
                    results[i] = batch
                    cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_workers, len(batches)))]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with cv:
                    while i not in results:
                        cv.wait()
                    batch = results.pop(i)
                slots.release()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            for t in threads:
                t.join()


def _to_device(batch, device: torch.device, stream):
    x, y = (torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
    if stream is None:
        return x.to(device), y.to(device), None
    with torch.cuda.stream(stream):
        x = x.pin_memory().to(device, non_blocking=True)
        y = y.pin_memory().to(device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)
    return x, y, copied


def device_batches(batches: Iterable, device) -> Iterator:
    """Each numpy (x, y) batch of `batches` as tensors on `device`.  On a
    CUDA device the copies run from pinned memory on a side stream, one
    batch ahead of the one yielded; the current stream waits for a batch's
    copy before the batch is used, and its tensors are recorded on the
    current stream, so that their memory is not reused while the step that
    reads them runs."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    pending = None
    for batch in batches:
        ready, pending = pending, _to_device(batch, device, stream)
        if ready is not None:
            yield _handed_over(*ready)
    if pending is not None:
        yield _handed_over(*pending)


def _handed_over(x, y, copied):
    if copied is not None:
        current = torch.cuda.current_stream(x.device)
        current.wait_event(copied)
        x.record_stream(current)
        y.record_stream(current)
    return x, y
