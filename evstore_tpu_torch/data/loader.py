"""Background prefetch of batches.

Port of `PrefetchIterator` and `prefetch` from
`evstore_tpu/data/loader.py`.  A worker thread produces the next batches
(a transform such as the device cache's lookup runs there) while the
consumer works on the current one.  The tier engine's ctypes calls release
the interpreter lock, so its policy pass overlaps the consumer's work.

As in the JAX package, an error on the worker is raised on the consumer's
side, after the batches that came before it.  Unlike the JAX package's
daemon thread, the worker can be stopped and joined: `close()` (or leaving
a `with` block) stops it after the batch it is producing and joins it, so
no thread outlives its consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


class PrefetchIterator:
    """Wrap a batch iterable with an N-deep background prefetch thread.
    With `to_device`, every element of a batch (or the batch itself) is
    moved there as a tensor."""

    _SENTINEL = object()

    def __init__(self, it: Iterable, depth: int = 2, to_device=None,
                 transform: Optional[Callable] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._device = None if to_device is None else torch.device(to_device)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, args=(iter(it),),
                                        name="prefetch", daemon=True)
        self._thread.start()

    def _move(self, a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self._device)

    def _fill(self, it):
        try:
            for batch in it:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    batch = self._transform(batch)
                if self._device is not None:
                    batch = (tuple(self._move(a) for a in batch)
                             if isinstance(batch, (tuple, list))
                             else self._move(batch))
                self._q.put(batch)
        except BaseException as e:   # surfaced on the consumer's side
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            self._stop.set()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the worker after its current batch and join it."""
        self._stop.set()
        while self._thread.is_alive():
            try:                      # unblock a worker waiting to put
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def prefetch(batches: Iterable, depth: int = 2, to_device=None,
             transform: Optional[Callable] = None) -> PrefetchIterator:
    """`with prefetch(batches, to_device="cuda") as it: for b in it: ...`;
    batches arrive already on the device, produced while the previous one
    is in use."""
    return PrefetchIterator(batches, depth, to_device, transform)
