"""Host buffers for copies between the host and the card.

`_Staging` is one host buffer, pinned on a card's machine and guarded by a
CUDA event: the trainable cache's upload and download, and each input of
the train step's `InputRing`.  The ring gives a step's host inputs two
slots, used in turn; on a card their copies run on a copy stream of the
ring's and the compute stream waits for them on an event, so neither the
host nor the compute stream waits for a copy.  On the CPU the same code
runs with pinning, the stream and the events off.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class _Staging:
    """A host buffer for one copy to or from the card at a time: pinned on
    the card's machine, and not handed out again before the copy that last
    used it has finished (a CUDA event, not a device-wide wait)."""

    def __init__(self, dev: torch.device, dtype: torch.dtype):
        self.dev, self.dtype = dev, dtype
        self.buf: Optional[torch.Tensor] = None
        self.event = None

    def take(self, n: int) -> torch.Tensor:
        self.wait()
        if self.buf is None or self.buf.numel() < n:
            size = max(n, 2 * (0 if self.buf is None else self.buf.numel()))
            self.buf = torch.empty(size, dtype=self.dtype,
                                   pin_memory=self.dev.type == "cuda")
        return self.buf[:n]

    def mark(self) -> None:
        """Call after queueing the copy that reads or fills the buffer."""
        if self.dev.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(self.dev))

    def ready(self) -> bool:
        """Whether `take` would hand the buffer out without waiting."""
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
            self.event = None


class _Slot:
    """One turn of an `InputRing`: per input a `_Staging` host buffer and
    a device buffer of the input's shape."""

    def __init__(self, dev: torch.device, dtypes: Sequence[torch.dtype]):
        self.host = [_Staging(dev, dt) for dt in dtypes]
        self.device: List[Optional[torch.Tensor]] = [None] * len(dtypes)
        self.copied = torch.cuda.Event() if dev.type == "cuda" else None

    def ready(self) -> bool:
        return all(s.ready() for s in self.host)

    def wait(self) -> None:
        for s in self.host:
            s.wait()


class InputRing:
    """A step's host inputs on their way to `dev`: input i is cast to
    `dtypes[i]`.  Per step: `take` the next slot (`ready` says whether
    `wait` would block), `stage` each input into its host buffer (a host
    copy, done on return, so the caller may then overwrite its array),
    `enqueue` its copy to the slot's device buffer, `hand_over` the copies
    to the compute stream, and `release` the slot after the step's last
    read of its device buffers.  A slot is staged again only after the
    compute stream has passed that release, so the host runs at most two
    steps ahead of the device.  A buffer is built again only when its
    input's shape grows (host) or changes (device)."""

    def __init__(self, dev: torch.device, dtypes: Sequence[torch.dtype]):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if self.cuda else None
        self.slots = [_Slot(dev, dtypes) for _ in range(2)]
        self.turn = 0

    def take(self) -> _Slot:
        slot = self.slots[self.turn]
        self.turn ^= 1
        return slot

    @staticmethod
    def stage(slot: _Slot, i: int, a: torch.Tensor) -> torch.Tensor:
        """Input i, a CPU tensor, cast into its host buffer."""
        host = slot.host[i].take(a.numel()).view(a.shape)
        host.copy_(a)
        return host

    def enqueue(self, slot: _Slot, i: int, host: torch.Tensor
                ) -> torch.Tensor:
        """Queue input i's copy from its host buffer to its device buffer;
        -> the device buffer."""
        d = slot.device[i]
        if d is None or d.shape != host.shape:
            # allocated for the compute stream, which may still use the
            # memory under another tensor: the copy stream waits for it
            d = slot.device[i] = torch.empty(host.shape, dtype=host.dtype,
                                             device=self.dev)
            if self.cuda:
                self.stream.wait_stream(torch.cuda.current_stream(self.dev))
        if self.cuda:
            with torch.cuda.stream(self.stream):
                d.copy_(host, non_blocking=True)
        else:
            d.copy_(host)
        return d

    def hand_over(self, slot: _Slot) -> None:
        """The compute stream's later work waits for the slot's copies."""
        if self.cuda:
            slot.copied.record(self.stream)
            torch.cuda.current_stream(self.dev).wait_event(slot.copied)

    @staticmethod
    def release(slot: _Slot) -> None:
        """Call after queueing the step's last read of the slot."""
        for s in slot.host:
            if s.buf is not None:
                s.mark()
