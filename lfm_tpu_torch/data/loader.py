"""Prefetching data loader: host datasets -> numpy batches (the port's copy
of lfm_tpu/data/loader.py, single process).

A background thread assembles batch N+1 while the card runs step N. Each
epoch's order is a shuffle seeded by ``seed + epoch`` (``set_epoch``, the
DistributedSampler equivalent); ``drop_last`` drops a ragged last batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 with_labels: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.with_labels = with_labels
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """Reshuffle per epoch."""
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def _assemble(self, indices) -> Dict[str, np.ndarray]:
        xs, ys = [], []
        for i in indices:
            item = self.dataset[int(i)]
            x, y = item if isinstance(item, tuple) else (item, 0)
            xs.append(x)
            ys.append(y)
        batch = {"x": np.stack(xs)}
        if self.with_labels:
            batch["y"] = np.asarray(ys, np.int64)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        n = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for b in range(n):
                    if stop.is_set():
                        return
                    sl = order[b * self.batch_size: (b + 1) * self.batch_size]
                    if len(sl) < self.batch_size and self.drop_last:
                        break
                    q.put(self._assemble(sl))
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    break
                yield b
        finally:
            stop.set()
            # unblock a worker waiting on a full queue, then let it end
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.01)
