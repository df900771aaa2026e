"""Host data pipeline: a deterministic, checkpointable, prefetching loader
of numpy batches (one device: the training loop moves each batch to it).

Each epoch is a permutation drawn from ``seed + epoch``; a batch is the
next ``global_batch`` rows of it (an epoch's remainder is dropped). A
worker thread makes up to ``prefetch`` batches ahead, and every batch of
that sequence is handed out exactly once, in order: ``state_dict()``
records the position after the batches handed out, not after the ones
made ahead, so a restart resumes at the first batch no step has seen.
(The reference's worker drops a batch whenever its queue stays full for
0.5 s and counts it as consumed, so which batches a slow step sees
depends on wall time; see ROADMAP C.5.)
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np


class ShardedLoader:
    def __init__(self, arrays: Dict[str, np.ndarray], global_batch: int, *,
                 seed: int = 0, prefetch: int = 2):
        self.arrays = arrays
        self.n = len(next(iter(arrays.values())))
        self.global_batch = global_batch
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0   # the position of the next batch to make
        self.pos = 0
        self._perm: Optional[np.ndarray] = None
        self._handed = {"epoch": 0, "pos": 0}  # after the last batch handed out

    # -- checkpointable state ---------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        return {**self._handed, "seed": self.seed}

    def load_state_dict(self, s: Dict[str, int]) -> None:
        self.epoch, self.pos, self.seed = s["epoch"], s["pos"], s["seed"]
        self._handed = {"epoch": self.epoch, "pos": self.pos}
        self._perm = None

    # -- iteration ----------------------------------------------------------------

    def _permutation(self) -> np.ndarray:
        if self._perm is None:
            rng = np.random.default_rng(self.seed + self.epoch)
            self._perm = rng.permutation(self.n)
        return self._perm

    def _next_indices(self) -> np.ndarray:
        if self.pos + self.global_batch > self.n:
            self.epoch += 1
            self.pos = 0
            self._perm = None
        idx = self._permutation()[self.pos:self.pos + self.global_batch]
        self.pos += self.global_batch
        return idx

    def _make_batch(self) -> Dict[str, np.ndarray]:
        idx = self._next_indices()
        return {k: v[idx] for k, v in self.arrays.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Batches from the position of the last one handed out; the
        batches a closed iterator had made ahead are made again."""
        if self._handed != {"epoch": self.epoch, "pos": self.pos}:
            self.epoch, self.pos = self._handed["epoch"], self._handed["pos"]
            self._perm = None
        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    item = (self._make_batch(),
                            {"epoch": self.epoch, "pos": self.pos})
                except Exception as e:  # handed to the consumer
                    item = e
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, Exception):
                    return

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                batch, self._handed = item
                yield batch
        finally:
            stop.set()
            t.join()

    def take(self, k: int) -> List[Dict[str, np.ndarray]]:
        it = iter(self)
        out = [next(it) for _ in range(k)]
        it.close()
        return out
