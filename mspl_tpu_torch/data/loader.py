"""Host-side batching / prefetching loader (port of mspl_tpu/data/loader.py).

A thread pool decodes samples and a bounded queue keeps `prefetch` batches
ready, so host decode overlaps device compute; the caller's wait for a
batch is the span `mspl.loader.wait` (`utils/profiling.py`).  Yields
dicts: image uint8 [B,H,W,C], label int32 [B,H,W], index int32 [B], valid
bool [B].  Only the tail batch is padded, always as a suffix (its last
item repeated, with valid=False), so the valid rows of every batch are a
prefix — `PseudoLabelGenerator(return_device=True)` relies on that.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from mspl_tpu_torch.utils.profiling import span


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def _make_batch(self, pool: ThreadPoolExecutor,
                    indices: np.ndarray) -> Dict[str, np.ndarray]:
        bs = self.batch_size
        valid = np.ones(bs, bool)
        if len(indices) < bs:  # pad the tail batch by repeating its last item
            valid[len(indices):] = False
            indices = np.concatenate(
                [indices, np.full(bs - len(indices), indices[-1])]
            )
        load_batch = getattr(self.dataset, "load_batch", None)
        if load_batch is not None:
            imgs, labs = load_batch(indices)
            labs = labs.astype(np.int32)
        else:
            samples = list(
                pool.map(self.dataset.load, [int(i) for i in indices]))
            imgs = np.stack([s[0] for s in samples])
            labs = np.stack([s[1] for s in samples]).astype(np.int32)
        return {
            "image": imgs,
            "label": labs,
            "index": indices.astype(np.int32),
            "valid": valid,
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_batches()

    def iter_batches(self,
                     start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate this epoch's batches, optionally skipping the first
        `start_batch` without decoding them (the order is a pure function of
        seed + epoch)."""
        order = self._order()
        self.epoch += 1
        bs = self.batch_size
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for b in range(start_batch, n_batches):
                    if stop.is_set():
                        return
                    chunk = order[b * bs: (b + 1) * bs]
                    try:
                        batch = self._make_batch(pool, chunk)
                    except Exception as e:  # surface worker errors
                        q.put(e)
                        return
                    q.put(batch)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            for _ in range(start_batch, n_batches):
                with span("mspl.loader.wait"):
                    item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
