"""Resumable, prefetching host data loader.

The port's copy of the JAX package's loader: the epoch permutation is drawn
once and stored, so a run can resume mid-epoch from a checkpoint's
`dataset_perm` and `batch_idx`.  A small thread pool decodes the samples of
a batch (the work is numpy, OpenCV and Pillow, which release the GIL) and a
prefetch thread keeps batches ready while the card computes.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


def collate(samples: list[dict]) -> dict:
    """Stack per-sample dicts into batch arrays (strings -> lists)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], str):
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals], axis=0)
    return out


class CheckpointDataLoader:
    """Iterates (batch index, batch) over a stored permutation.

    `drop_last` defaults to True, as for training; evaluation passes False
    so that every sample of the split is covered."""

    def __init__(self, dataset, batch_size: int = 32, shuffle: bool = True, num_workers: int = 4,
                 checkpoint: Optional[dict] = None, seed: Optional[int] = None, prefetch: int = 2,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last

        n = len(dataset)
        if checkpoint is not None and checkpoint.get("dataset_perm") is not None:
            self.dataset_perm = np.asarray(checkpoint["dataset_perm"], dtype=np.int64)
            self.checkpoint_batch_idx = int(checkpoint.get("batch_idx", 0))
        else:
            rng = np.random.default_rng(seed)
            self.dataset_perm = rng.permutation(n) if shuffle else np.arange(n)
            self.checkpoint_batch_idx = 0

    def __len__(self):
        n = len(self.dataset_perm)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _load_batch(self, indices) -> dict:
        if self.num_workers > 1:
            with ThreadPoolExecutor(self.num_workers) as ex:
                samples = list(ex.map(lambda i: self.dataset[int(i)], indices))
        else:
            samples = [self.dataset[int(i)] for i in indices]
        return collate(samples)

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        nb = len(self)
        start = self.checkpoint_batch_idx
        self.checkpoint_batch_idx = 0  # the resume offset applies once

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            for b in range(start, nb):
                if stop.is_set():
                    return
                idx = self.dataset_perm[b * self.batch_size:(b + 1) * self.batch_size]
                try:
                    q.put((b, self._load_batch(idx)))
                except Exception as e:  # handed to the consumer, which raises it
                    q.put((b, e))
                    return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                got = q.get()
                if got is None:
                    return
                b, batch = got
                if isinstance(batch, Exception):
                    raise batch
                yield b, batch
        finally:
            stop.set()
