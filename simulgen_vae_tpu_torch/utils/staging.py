"""Host values for the card, sent as one copy.

A :class:`Staging` holds one buffer of 4-byte words on the device and a ring
of rows of the same width in pinned host memory. The caller fills the row
:meth:`Staging.row` hands out (numpy views: ``int32``, or ``.view(float32)``
/ ``.view(uint32)`` for other words) and :meth:`Staging.send` copies it into
the device buffer with one ``copy_(non_blocking=True)`` on the current
stream; kernels then read their host values (seeds, learning rates, bias
corrections) from the buffer, so a captured CUDA graph reads each replay's
values instead of freezing the ones it saw at capture. The device buffer is
the same tensor on every call, and a copy into it is ordered behind the
work already queued on the stream that reads it.

A ring row is handed out again only after the copy out of it has run (the
event recorded behind that copy): the host runs at most ``slots`` sends
ahead of the card and never overwrites a row a pending copy still reads. On
the CPU the ring has one row and the copy is immediate.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


class Staging:
    def __init__(self, width: int, device, slots: int = 4):
        device = torch.device(device)
        on_card = device.type == "cuda"
        self.device = device
        self.buffer = torch.zeros(width, dtype=torch.int32, device=device)
        self._ring = torch.zeros((slots if on_card else 1, width), dtype=torch.int32,
                                 pin_memory=on_card)
        self._rows = self._ring.numpy()
        self._events: List[Optional[torch.cuda.Event]] = (
            [torch.cuda.Event() for _ in range(slots)] if on_card else [])
        self._next, self._filled = 0, None

    @property
    def width(self) -> int:
        return self.buffer.numel()

    def row(self) -> np.ndarray:
        """The next free host row (``int32`` words), once its last copy has run."""
        slot = self._next
        self._next = (slot + 1) % len(self._rows)
        if self._events:
            self._events[slot].synchronize()
        self._filled = slot
        return self._rows[slot]

    def send(self) -> torch.Tensor:
        """Copies the row last handed out into the device buffer; returns the buffer."""
        slot = self._filled
        if slot is None:
            raise RuntimeError("send() without a row() filled before it")
        self.buffer.copy_(self._ring[slot], non_blocking=bool(self._events))
        if self._events:
            self._events[slot].record(torch.cuda.current_stream(self.device))
        self._filled = None
        return self.buffer
