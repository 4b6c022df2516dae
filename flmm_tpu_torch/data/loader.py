"""Prefetching data loader (flmm_tpu/data/loader.py): a thread pool fetches
samples and assembles batches ahead of the consumer, in the sampler's
order.  ``EpochSampler`` is mmengine's DefaultSampler(shuffle=True) with
DistSamplerSeedHook: the permutation depends only on (seed, epoch), so every
process draws the same order and takes its own stride slice."""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Iterator


class EpochSampler:
    """Epoch-seeded shuffling with optional per-process sharding."""

    def __init__(self, n: int, seed: int = 0, shuffle: bool = True,
                 num_shards: int = 1, shard_id: int = 0):
        self.n = n
        self.seed = seed
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard_id = shard_id

    def epoch(self, epoch: int) -> list[int]:
        order = list(range(self.n))
        if self.shuffle:
            random.Random(self.seed + epoch).shuffle(order)
        return order[self.shard_id::self.num_shards]


class PrefetchLoader:
    """Iterate batches assembled by a worker pool.

    Args:
      sample_fn: ``index -> sample dict`` (thread-safe: the readers do numpy
        work and call the host library, which holds no state).
      collate_fn: ``list[sample] -> batch``.
      sampler: EpochSampler.
      batch_size: samples a batch; the trailing partial batch is dropped.
      num_workers: sample-fetch threads.
      prefetch: most ready batches queued ahead.

    A worker's exception is raised in the consumer.  The workers stop, and
    are joined, when the consumer leaves an epoch, at its end or early.
    """

    def __init__(self, sample_fn: Callable, collate_fn: Callable,
                 sampler: EpochSampler, batch_size: int,
                 num_workers: int = 4, prefetch: int = 2):
        self.sample_fn = sample_fn
        self.collate_fn = collate_fn
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def epoch(self, epoch: int, start: int = 0) -> Iterator:
        """The batches of ``epoch`` from its batch ``start`` on (a resumed
        run skips the ones it has trained on without building them)."""
        indices = self.sampler.epoch(epoch)
        n_batches = len(indices) // self.batch_size - start
        if n_batches <= 0:
            return
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        job_q: queue.Queue = queue.Queue()
        for bi in range(n_batches):
            lo = (start + bi) * self.batch_size
            job_q.put((bi, indices[lo:lo + self.batch_size]))
        results: dict = {}
        lock = threading.Lock()
        next_emit = [0]
        error: list = []
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self.collate_fn([self.sample_fn(i)
                                             for i in idxs])
                except Exception as e:  # raised again in the consumer
                    error.append(e)
                    out_q.put(None)
                    return
                with lock:  # emit in order
                    results[bi] = batch
                    while next_emit[0] in results:
                        out_q.put(results.pop(next_emit[0]))
                        next_emit[0] += 1

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for _ in range(n_batches):
                batch = out_q.get()
                if batch is None:
                    raise error[0]
                yield batch
        finally:  # also when the consumer stops early or a worker failed
            stop.set()
            for t in threads:
                while t.is_alive():
                    while not out_q.empty():  # a worker may wait to put
                        out_q.get_nowait()  # (no other thread takes)
                    t.join(timeout=0.01)

    def __call__(self, epochs: int) -> Iterator:
        for e in range(epochs):
            yield from self.epoch(e)
