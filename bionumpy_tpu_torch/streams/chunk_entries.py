"""Re-chunk a stream to fixed entry counts (reference:
bionumpy/streams/chunk_entries.py; the port's copy of
bionumpy_tpu/streams/chunk_entries.py)."""
from __future__ import annotations

from typing import Generator

import numpy as np

from .stream import BnpStream


def _chunk_entries(stream: BnpStream, n_entries: int) -> Generator:
    parts = []
    buffered = 0
    for chunk in stream:
        parts.append(chunk)
        buffered += len(chunk)
        while buffered >= n_entries:
            total = np.concatenate(parts) if len(parts) > 1 else parts[0]
            yield total[:n_entries]
            parts = [total[n_entries:]]
            buffered = len(parts[0])
    if buffered:
        yield np.concatenate(parts) if len(parts) > 1 else parts[0]


def chunk_entries(stream: BnpStream, n_entries: int) -> BnpStream:
    return stream.__class__(_chunk_entries(stream, n_entries))
