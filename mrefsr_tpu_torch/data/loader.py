"""Batch collation and the threaded data loader (port of
``mrefsr_tpu/data/loader.py``, which takes the place of the reference's
torch ``DataLoader`` with worker processes).

Worker threads run the dataset's ``__getitem__``: Pillow's decode and
resize, where the time goes, release the interpreter lock. Batches are
numpy arrays, collated in index order whatever the number of workers, so
a dataset that draws nothing at random gives the threaded loader the
batches of its synchronous path.
"""
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def default_collate(samples):
    """Stack a list of ``{key: array | scalar | str}`` dicts into batched
    numpy arrays; scalars and tuples of ints become arrays, anything else
    a list."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals, axis=0)
        elif isinstance(first, (int, float, bool, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        elif isinstance(first, tuple) and all(
                isinstance(x, (int, np.integer)) for x in first):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """An iterable of collated batches.

    Args:
        dataset: an object with ``__getitem__`` and ``__len__``.
        batch_size: samples a batch (a process's batch).
        shuffle: shuffle each epoch where no sampler is given, with
            ``random.Random(seed + epoch)``.
        sampler: an index sampler (``EnlargedSampler``) or None.
        num_workers: decode threads; 0 loads on the caller's thread.
        drop_last: drop the last batch where it is short.
        seed: the shuffle's base seed.
        prefetch_batches: collated batches the workers may hold ahead.
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, sampler=None,
                 num_workers=0, drop_last=False, seed=None,
                 collate_fn=default_collate, prefetch_batches=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.collate_fn = collate_fn
        self.prefetch_batches = prefetch_batches
        self._epoch = 0

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None \
            else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self._epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, 'set_epoch'):
            self.sampler.set_epoch(epoch)

    def _indices(self):
        if self.sampler is not None:
            return list(self.sampler)
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random((self.seed or 0) + self._epoch).shuffle(idx)
        return idx

    def _batches(self, indices):
        for i in range(0, len(indices), self.batch_size):
            chunk = indices[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self):
        indices = self._indices()
        if self.num_workers <= 0:
            for chunk in self._batches(indices):
                yield self.collate_fn([self.dataset[j] for j in chunk])
            return
        yield from self._iter_threaded(indices)

    def _produce(self, chunks, batch_q, stop):
        """The workers' side: samples submitted in index order across batch
        boundaries (a pool per batch would wait for each batch's slowest
        sample), collected in that order, and each batch put on
        ``batch_q``; then None, or the exception that stopped them."""
        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                flat = [j for chunk in chunks for j in chunk]
                futs = deque()
                try:
                    pos = 0
                    cap = self.batch_size + max(self.num_workers, 1)
                    for chunk in chunks:
                        cur = []
                        while len(cur) < len(chunk):
                            if stop.is_set():
                                return
                            while pos < len(flat) and len(futs) < cap:
                                futs.append(pool.submit(
                                    self.dataset.__getitem__, flat[pos]))
                                pos += 1
                            cur.append(futs.popleft().result())
                        batch_q.put(self.collate_fn(cur))
                finally:
                    # drop the samples not started, before the pool waits
                    # for its threads (early stop or a worker's exception)
                    while futs:
                        futs.popleft().cancel()
        except BaseException as e:  # noqa: B036
            # a producer that dies without a word would leave the
            # consumer waiting for ever
            batch_q.put(e)
            return
        batch_q.put(None)

    def _iter_threaded(self, indices):
        batch_q = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        thread = threading.Thread(
            target=self._produce,
            args=(list(self._batches(indices)), batch_q, stop), daemon=True)
        thread.start()
        try:
            while True:
                batch = batch_q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # drain, so that a producer blocked on a full queue can end
            while thread.is_alive():
                try:
                    batch_q.get(timeout=0.1)
                except queue.Empty:
                    pass
