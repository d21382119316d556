"""Parallel inflation of multi-member gzip streams (the port's copy of
bionumpy_tpu/io/pgzip.py).

A single deflate stream is a sequential bitstream, but gzip files are
routinely CONCATENATIONS of independent members (bgzf, pigz output,
per-chunk compressed FASTQ, `cat a.gz b.gz`), and members inflate
concurrently on a thread pool: both the native decoder and CPython's
zlib release the GIL.

Boundary detection is heuristic-then-verified: a candidate is the gzip
magic (1f 8b 08) with a sane FLG byte; every segment must then inflate
to an exact end-of-stream at the next candidate, and segments that fail
(a magic byte pattern occurring inside compressed data) are merged with
their successor and retried, so the result is always exact.

  member_offsets(data)    magic-scan + header validation of boundaries
  inflate_members(...)    pool inflation with false-positive repair
  open_gzip(path)         file-like for the readers (io/files.py): every
                          member inflated at once into one buffer when the
                          ISIZE table is clean, a windowed member stream
                          otherwise, one native inflate for one member
"""
from __future__ import annotations

import io
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# gzip magic + deflate method; FLG reserved bits (5-7) must be zero
_MAGIC = bytes([0x1F, 0x8B, 0x08])
_FLG_RESERVED = 0xE0


def member_offsets(data) -> np.ndarray:
    """Candidate gzip member start offsets in `data` (always includes 0).

    Candidates are verified during inflation; a false positive (the
    3-byte magic appearing inside compressed data) is repaired by
    merging, so over-reporting here is harmless.  Scans with bytes.find
    (memmem), far faster than an elementwise numpy pass."""
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    if len(data) < 18:  # minimal gzip file is 18 bytes
        return np.array([0], dtype=np.int64)
    starts = []
    i = data.find(_MAGIC)
    limit = len(data) - 18
    while 0 <= i <= limit:
        if (data[i + 3] & _FLG_RESERVED) == 0:
            starts.append(i)
        i = data.find(_MAGIC, i + 1)
    if not starts or starts[0] != 0:
        starts.insert(0, 0)
    return np.array(starts, dtype=np.int64)


def _inflate_segment(segment: bytes) -> bytes:
    """Inflate one candidate segment; raises zlib.error if the segment is
    not a whole number of complete members (false-positive boundary).

    Uses the native libdeflate-style decoder when built; zlib
    otherwise."""
    from .. import native
    out = native.gzip_inflate(segment)
    if out is not None:
        return out
    return _inflate_segment_zlib(segment)


def _inflate_segment_zlib(segment: bytes) -> bytes:
    out = []
    rest = segment
    while rest:
        obj = zlib.decompressobj(wbits=31)
        out.append(obj.decompress(rest))
        while not obj.eof:
            tail = obj.unconsumed_tail
            if not tail:
                raise zlib.error("truncated gzip member")
            out.append(obj.decompress(tail))
        rest = obj.unused_data
    return b"".join(out)


def inflate_members(data, offsets=None, n_threads: int = None,
                    pool: ThreadPoolExecutor = None) -> list:
    """Inflate a (possibly multi-member) gzip byte string in parallel.

    Returns the list of inflated per-segment byte strings, in order;
    b"".join(result) is the full stream."""
    if offsets is None:
        offsets = member_offsets(data)
    data = bytes(data) if isinstance(data, np.ndarray) else data
    bounds = list(offsets) + [len(data)]
    segments = [data[bounds[i]:bounds[i + 1]]
                for i in range(len(bounds) - 1)]
    own_pool = None
    if pool is None:
        own_pool = pool = ThreadPoolExecutor(
            n_threads or min(8, (os.cpu_count() or 1)))
    try:
        results = _inflate_with_repair(segments, pool)
    finally:
        if own_pool is not None:
            own_pool.shutdown(wait=False)
    return results


def _inflate_with_repair(segments: list, pool: ThreadPoolExecutor) -> list:
    futures = [pool.submit(_inflate_segment, s) for s in segments]
    results = []
    i = 0
    while i < len(segments):
        try:
            results.append(futures[i].result())
            i += 1
        except zlib.error:
            # false-positive boundary: merge with the next segment(s)
            if i + 1 >= len(segments):
                raise
            merged = segments[i] + segments[i + 1]
            segments[i: i + 2] = [merged]
            futures[i: i + 2] = [pool.submit(_inflate_segment, merged)]
    return results


class ArrayStream(io.RawIOBase):
    """Read-only file-like over a fully-inflated uint8 numpy buffer.

    The copy chain slab -> tobytes -> BytesIO -> read() -> frombuffer
    costs 3 full passes over the inflated file; this serves normal reads
    as small-slice copies and exposes `read_array()` so NumpyFileReader's
    whole-file path gets the remaining bytes as a ZERO-COPY view."""

    def __init__(self, arr: np.ndarray):
        self._arr = arr
        self._pos = 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = len(self._arr) - self._pos
        out = bytes(memoryview(self._arr[self._pos: self._pos + n]))
        self._pos += len(out)
        return out

    def read_array(self) -> np.ndarray:
        """Remaining bytes as a numpy view (no copy); consumes them."""
        out = self._arr[self._pos:]
        self._pos = len(self._arr)
        return out

    def readline(self, limit: int = -1) -> bytes:
        mv = memoryview(self._arr)
        end = self._arr.size
        idx = bytes(mv[self._pos: min(self._pos + 4096, end)]).find(b"\n")
        if idx < 0:  # long line: fall back to a full-tail search
            idx = bytes(mv[self._pos:]).find(b"\n")
        stop = end if idx < 0 else self._pos + idx + 1
        if limit is not None and limit >= 0:
            stop = min(stop, self._pos + limit)
        out = bytes(mv[self._pos: stop])
        self._pos = stop
        return out

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = len(self._arr) + offset
        self._pos = max(0, min(self._pos, len(self._arr)))
        return self._pos


class _ParallelMemberStream(io.RawIOBase):
    """Read-only file-like over a multi-member gzip byte string that
    inflates members ahead on a thread pool, keeping at most `window`
    segments in flight (bounded memory)."""

    _HISTORY_CAP = 1 << 20  # pushback window for relative backward seek

    def __init__(self, data: bytes, offsets, n_threads: int = 2,
                 window: int = 8):
        self._data = data
        bounds = list(offsets) + [len(data)]
        self._segments = [data[bounds[i]:bounds[i + 1]]
                          for i in range(len(bounds) - 1)]
        self._pool = ThreadPoolExecutor(max(1, n_threads))
        self._window = max(2, window)
        self._futures = []
        self._next_submit = 0
        self._next_take = 0
        self._buf = bytearray()
        self._pos = 0
        self._history = bytearray()
        self._fill_window()

    def _fill_window(self):
        while (self._next_submit < len(self._segments)
               and len(self._futures) < self._window):
            self._futures.append(self._pool.submit(
                _inflate_segment, self._segments[self._next_submit]))
            self._next_submit += 1

    def _take_one(self) -> bool:
        if not self._futures:
            return False
        fut = self._futures.pop(0)
        try:
            self._buf += fut.result()
        except zlib.error:
            # repair: keep merging the failed segment with its successor
            # until it inflates to an exact member end (false-positive
            # boundaries split a real member; they can only over-split,
            # so merging forward always converges)
            i = self._next_take
            while True:
                if i + 1 >= len(self._segments):
                    raise
                merged = self._segments[i] + self._segments[i + 1]
                self._segments[i: i + 2] = [merged]
                if self._next_submit > i + 1:
                    # successor's future was in flight: drop it; indices
                    # after the merge shift down by one
                    self._futures.pop(0)
                    self._next_submit -= 1
                else:
                    self._next_submit = i + 1
                try:
                    self._buf += _inflate_segment(merged)
                    break
                except zlib.error:
                    continue
        self._next_take += 1
        self._fill_window()
        return True

    def readable(self):
        return True

    def seekable(self):
        return True  # limited: relative backward within the history cap

    def _emit(self, out: bytes) -> bytes:
        self._pos += len(out)
        self._history += out
        if len(self._history) > self._HISTORY_CAP:
            del self._history[: len(self._history) - self._HISTORY_CAP]
        return out

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            while self._take_one():
                pass
            out = bytes(self._buf)
            self._buf = bytearray()
            return self._emit(out)
        while len(self._buf) < n and self._take_one():
            pass
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return self._emit(out)

    def readline(self, limit: int = -1) -> bytes:
        while True:
            idx = self._buf.find(b"\n")
            if idx >= 0 or not self._take_one():
                break
        if idx := self._buf.find(b"\n") + 1:
            out = bytes(self._buf[:idx])
            del self._buf[:idx]
        else:
            out = bytes(self._buf)
            self._buf = bytearray()
        return self._emit(out)

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 1:
            back = -offset
        elif whence == 0:
            back = self._pos - offset
        else:
            raise io.UnsupportedOperation("seek from end")
        if back < 0 or back > len(self._history):
            raise io.UnsupportedOperation(
                f"can only seek back up to {len(self._history)} bytes")
        if back:
            self._buf[:0] = self._history[len(self._history) - back:]
            del self._history[len(self._history) - back:]
            self._pos -= back
        return self._pos

    def close(self):
        self._pool.shutdown(wait=False)
        super().close()


def open_gzip(path: str, n_threads: int = 2, max_in_memory: int = 1 << 31):
    """Open a .gz file for reading, using parallel member inflation when
    the file is multi-member and fits in memory; plain (sequential) gzip
    otherwise.  Returns a binary file-like."""
    from .gzip_reading import gzip as _gzip
    size = os.path.getsize(path)
    if size > max_in_memory:
        return _gzip.open(path, "rb")
    with open(path, "rb") as f:
        data = f.read()
    offsets = member_offsets(data)
    if len(offsets) < 2:
        # single member: one-shot native inflate (csrc/host/inflate.cpp,
        # GIL-free) beats python-gzip's streaming read loop; fall back
        # to sequential gzip if the native decoder is unavailable or
        # the candidate scan mis-detected (e.g. corrupt stream)
        from .. import native
        try:
            raw = native.gzip_inflate(data)
        except zlib.error:
            # e.g. trailing padding, which the python gzip module
            # tolerates — the fallback must actually happen
            raw = None
        if raw is not None:
            return io.BytesIO(raw)
        return _gzip.open(path, "rb")
    # multi-member with a trustworthy ISIZE table and a bounded raw
    # size: inflate EVERY member in parallel straight into one buffer
    # (the member-window streaming path costs an extra copy chain)
    from ..pipeline import _member_table
    tbl = _member_table(data)
    if tbl is not None and int(tbl[1].sum()) <= max_in_memory:
        from .. import native
        bounds, isz = tbl
        raw_off = np.insert(np.cumsum(isz), 0, 0)
        out = np.empty(int(raw_off[-1]), np.uint8)
        pool = ThreadPoolExecutor(max(n_threads, 2))
        try:
            futs = [pool.submit(native.gzip_inflate_into, data,
                                int(bounds[i]), int(bounds[i + 1]),
                                out, int(raw_off[i]), int(isz[i]))
                    for i in range(len(isz))]
            ok = all(f.result() for f in futs)
        finally:
            pool.shutdown(wait=False)
        if ok:
            return ArrayStream(out)
    return _ParallelMemberStream(data, offsets, n_threads=n_threads)
