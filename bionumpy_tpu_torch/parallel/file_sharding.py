"""Entry-aligned byte-range file sharding for multi-host data
parallelism (the port's copy of bionumpy_tpu/parallel/file_sharding.py,
host code).

Each host reads only its byte range of the input file; range boundaries
snap forward to the next entry start, so shards partition the records
exactly — the distributed analog of the single-host reader's
incomplete-entry carry (reference: bionumpy/io/parser.py:160-165).
psum-merging of per-shard combiner state happens in kmer_parallel.py
and reductions.py.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def _snap_to_fastq_entry(f, pos: int, file_size: int) -> int:
    """First FASTQ entry start at or after pos: a line starting with '@'
    whose third successor line starts with '+' (disambiguates '@' in
    quality strings)."""
    if pos == 0:
        return 0
    f.seek(max(pos - 1, 0))
    window = f.read(min(1 << 20, file_size - max(pos - 1, 0)))
    # candidate line starts
    offsets = [i + 1 for i, b in enumerate(window) if b == ord("\n")]
    for off in offsets:
        if off >= len(window):
            break
        if window[off: off + 1] != b"@":
            continue
        # check that two lines later starts with '+'
        nl1 = window.find(b"\n", off)
        nl2 = window.find(b"\n", nl1 + 1) if nl1 != -1 else -1
        if nl2 != -1 and window[nl2 + 1: nl2 + 2] == b"+":
            return max(pos - 1, 0) + off
    return file_size


def _snap_to_line_start(f, pos: int, file_size: int,
                        entry_marker: Optional[bytes] = None) -> int:
    if pos == 0:
        return 0
    f.seek(pos - 1)
    window = f.read(min(1 << 20, file_size - pos + 1))
    idx = 0
    while True:
        nl = window.find(b"\n", idx)
        if nl == -1:
            return file_size
        start = pos - 1 + nl + 1
        if entry_marker is None or \
                window[nl + 1: nl + 2] == entry_marker:
            return start
        idx = nl + 1


def shard_byte_ranges(filename: str, n_shards: int,
                      file_format: str = "fastq"
                      ) -> List[Tuple[int, int]]:
    """[(start, stop)] byte ranges partitioning the file on entry
    boundaries.  Supported formats: 'fastq', 'fasta' (multi-line, '>'
    markers), 'lines' (one entry per line: bed/vcf bodies/sizes)."""
    file_size = os.path.getsize(filename)
    raw_bounds = [(file_size * i) // n_shards
                  for i in range(1, n_shards)]
    bounds = [0]
    with open(filename, "rb") as f:
        for pos in raw_bounds:
            if file_format == "fastq":
                snapped = _snap_to_fastq_entry(f, pos, file_size)
            elif file_format == "fasta":
                snapped = _snap_to_line_start(f, pos, file_size, b">")
            elif file_format == "lines":
                snapped = _snap_to_line_start(f, pos, file_size, None)
            else:
                raise ValueError(file_format)
            bounds.append(min(snapped, file_size))
    bounds.append(file_size)
    bounds = sorted(set(bounds))
    return list(zip(bounds[:-1], bounds[1:]))


def read_shard(filename: str, byte_range: Tuple[int, int],
               buffer_type=None):
    """Parse one byte range into a record batch (host side of one data-
    parallel worker)."""
    from ..io.files import _get_buffer_type
    from pathlib import PurePath
    start, stop = byte_range
    if buffer_type is None:
        suffix = PurePath(filename).suffixes[-1]
        buffer_type = _get_buffer_type(suffix)
    with open(filename, "rb") as f:
        f.seek(start)
        raw = f.read(stop - start)
    if not raw:
        return buffer_type.dataclass.empty()
    if not raw.endswith(b"\n"):
        raw += b"\n"
    chunk = np.frombuffer(raw, dtype=np.uint8)
    if hasattr(buffer_type, "_new_entry_marker"):
        chunk = np.append(
            chunk, np.uint8(ord(buffer_type._new_entry_marker)))
    buf = buffer_type.from_raw_buffer(chunk)
    return buf.get_data()
