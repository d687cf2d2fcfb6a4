"""Generic fixed-length sync-pattern message framer.

The array-pipeline counterpart of the reference's streaming MessageFramer
(bits/MessageFramer.java:39): instead of a per-bit shift-register compare,
sync detection is one vectorized XOR-popcount correlation over the whole
bit block, and message extraction is slicing at the hit offsets.  Carries
a tail of unconsumed bits so chunked streaming matches one-shot decoding.
"""
from __future__ import annotations

import numpy as np

from .bits import to_bits, xor_popcount_correlate

__all__ = ["MessageFramer"]


class MessageFramer:
    """Detect `sync` (exact match by default) and emit `message_length`-bit
    messages that START at the first sync bit (matching the reference,
    whose framed message includes the sync prefix).

    Overlapping syncs inside a message body are ignored — once a message
    starts, the next sync search begins after it ends (the reference
    framer likewise stops searching while assembling).
    """

    def __init__(self, sync, message_length: int, max_bit_errors: int = 0):
        self.sync = to_bits(sync)
        self.message_length = int(message_length)
        if self.message_length < len(self.sync):
            raise ValueError("message_length shorter than sync pattern")
        self.max_bit_errors = int(max_bit_errors)
        self._tail = np.zeros((0,), np.uint8)

    def reset(self) -> None:
        self._tail = np.zeros((0,), np.uint8)

    def process(self, bits: np.ndarray) -> list[np.ndarray]:
        """Append a bit block; return every complete message found."""
        buf = np.concatenate([self._tail, to_bits(bits)])
        errors = xor_popcount_correlate(buf, self.sync)
        messages: list[np.ndarray] = []
        pos = 0          # first alignment not yet ruled out
        pending = None   # sync hit whose message is still incomplete
        while pos < len(errors):
            hits = np.nonzero(errors[pos:] <= self.max_bit_errors)[0]
            if len(hits) == 0:
                pos = len(errors)
                break
            start = pos + int(hits[0])
            if start + self.message_length > len(buf):
                pending = start
                break
            messages.append(buf[start:start + self.message_length].copy())
            pos = start + self.message_length
        if pending is not None:
            keep = len(buf) - pending           # whole partial message
        else:
            # alignments < len(errors) are clean/consumed; a future sync
            # can only straddle the last sync-1 bits
            keep = min(len(buf) - pos, len(self.sync) - 1)
        self._tail = buf[len(buf) - keep:].copy() if keep > 0 else \
            np.zeros((0,), np.uint8)
        return messages
