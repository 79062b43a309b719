"""Background-prefetch loader (port of data/prefetch.py): a bounded producer
thread runs the collator (tokenization) for the next batches while the
device encodes the current one.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class PrefetchLoader:
    """Wrap any batch iterable with an N-deep background prefetch queue.
    An exception in the producer is raised in the consumer once the batches
    before it are consumed."""

    _SENTINEL = object()

    def __init__(self, loader: Iterable, depth: int = 4):
        self.loader = loader
        self.depth = depth
        self.batch_size = getattr(loader, "batch_size", None)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list = []

        def produce():
            try:
                for batch in self.loader:
                    q.put(batch)
            except BaseException as e:  # handed to the consumer, re-raised
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                break
            yield item
        t.join()
        if err:
            raise err[0]
