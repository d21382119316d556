"""Streamed gzip FASTQ -> exact k-mer counts on the card (the port of
the single-device packed path of bionumpy_tpu/pipeline.py).

File-in to counts-out, with the stages overlapped:

  inflate      multi-member gzip members on a thread pool (io/pgzip.py)
  parse+pack   fused native FASTQ scan + encode + 2-bit pack (csrc/host)
  H2D          packed words (0.25 B/base) + row ends
  count        kmer_keys kernel + sort + run compaction (ops/kmers.py)

or, with the device-parse transport, the raw inflated bytes cross
instead and the scan, encode and pack run on the card (ops/parse.py)
before the same count; "auto" times one batch of each and keeps the
faster.  Then:

  fold         per-batch tables merge into a device accumulator every
               ACC_FOLD batches (parallel/sparse_parallel.py)
  D2H          the final (hash, count) table only, in one copy

Host threads prepare later batches while the device counts earlier
ones, so wall time approaches max(host stage, device stage) instead of
the sum.  Every stage reports through bionumpy_tpu_torch.instrument:
the entry points are call spans, the stages that enqueue device work
carry its device time, and the tasks handed to other threads carry the
call's id (instrument.carried).
Hashes, counts and stats equal those of the JAX package's
count_kmers_fastq on the same file.

get_motif_matches_fastq streams the same batches through the motif scan
(pwm_scores kernel + on-device match compaction, ops/pwm.py) and fetches
only the match positions, one batch late; count_minimizers_fastq streams
them through the minimizer table (kmer_keys kernel + windowed min,
ops/minimizers.py) and the same fold and fetch as the k-mer count.
binned_pileup_bed reads a BED file, rebases its intervals onto one
bin-aligned genome axis and runs one binned pileup (ops/tracks.py).

With mesh= (parallel/mesh.Mesh) each of the four splits its work over
the mesh's devices: a FASTQ batch of target_bases per device is cut on
read boundaries into one shard a device (_split_fastq_entries, the JAX
package's split, so shard order and read indices agree), every shard
runs the single-device ops on its device, and one step a batch merges
the shards on the lead device (parallel/sparse_parallel.py,
parallel/reductions.py).
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from . import native
from .encodings import DNAEncoding
from .encodings.kmer_encodings import KmerEncoding
from .genomic_data.global_offset import GlobalOffset
from .instrument import add, call_span, carried, stage
from .io.files import bnp_open
from .io.pgzip import _inflate_segment, inflate_members, member_offsets
from .ops.device import bucket_size, fetch_rows, resolve_device
from .ops.kmer_kernels import MAX_K
from .ops.kmers import SENTINEL, WORD_BASES, kmer_sentinel_table_packed
from .ops.minimizers import minimizer_sentinel_table_packed
from .ops.parse import fastq_to_sparse_kmer_table
from .ops.pwm import pwm_match_compact, pwm_scores_packed
from .ops.tracks import binned_pileup
from .parallel.mesh import Mesh, put_sharded
from .parallel.reductions import sharded_binned_pileup_step
from .parallel.sparse_parallel import (merge_hash_tables,
                                       sharded_minimizer_count_fold_step,
                                       sharded_pwm_match_step,
                                       sharded_sparse_count_fold_step)
from .sequence.count_encoded import SparseEncodedCounts

logger = logging.getLogger(__name__)

# positions per device batch (the JAX package's bucket, kept so both
# packages cut identical batches)
TARGET_BUCKET = 1 << 25

# batch tables merged into the device accumulator per fold
ACC_FOLD = 8
FOLD_EVERY = ACC_FOLD  # the JAX package's alias

# host-side spill threshold on the k-mers the accumulator may hold:
# beyond it the accumulator is fetched and folded into a host table.
# The JAX package needs it because its merge sums counts in int32; the
# port's counts are int64, but it keeps the same bound so both packages
# spill at the same batches (tests shrink it to exercise the path)
_SPILL_LIMIT = (1 << 31) - 1

# host batches whose H2D copy and count may be in flight at once; the
# host blocks on older ones (and keeps their buffers alive until then)
_IN_FLIGHT = 2

_PART_BYTES = 8 << 20  # part size for non-member sources


def _inflated_parts(path: str, pool: ThreadPoolExecutor) -> Iterator[bytes]:
    """Yield inflated byte pieces (gzip members, or ~8 MB slices for
    plain / single-member files).  Multi-member inflation runs ahead on
    the pool with a bounded window."""
    with stage("read"):
        with open(path, "rb") as f:
            data = f.read()
    if path.endswith(".gz"):
        yield from _inflated_parts_from(data, pool)
        return
    for i in range(0, len(data), _PART_BYTES):
        yield data[i: i + _PART_BYTES]


def _inflated_parts_from(data: bytes, pool: ThreadPoolExecutor,
                         start: int = 0,
                         part_bytes: int = None) -> Iterator[bytes]:
    """Stream inflated members of data[start:] with a bounded look-ahead
    window on the pool (the repairing generic path).  `part_bytes`
    bounds the single-member whole-inflate parts so downstream batch
    cuts can honor a small target (batches are cut at part
    granularity)."""
    if part_bytes is None:
        part_bytes = _PART_BYTES
    if start:
        data = data[start:]
    offsets = member_offsets(data)
    if len(offsets) < 2:
        with stage("inflate", n_bytes=len(data)):
            raw = _inflate_segment(data)
        for i in range(0, len(raw), part_bytes):
            yield raw[i: i + part_bytes]
        return
    import zlib
    bounds = list(offsets) + [len(data)]
    futs = deque()
    window = 16
    j = 0
    n_seg = len(bounds) - 1
    taken = 0
    try:
        while taken < n_seg:
            while j < n_seg and len(futs) < window:
                futs.append(pool.submit(
                    _inflate_segment, data[bounds[j]: bounds[j + 1]]))
                j += 1
            with stage("inflate",
                       n_bytes=int(bounds[taken + 1] - bounds[taken])):
                part = futs.popleft().result()
            taken += 1
            yield part
    except zlib.error:
        # false-positive boundary: fall back to the repairing inflater
        # for everything not yet yielded
        for f in futs:
            f.cancel()
        rel = offsets[taken:] - int(bounds[taken])
        with stage("inflate"):
            parts = inflate_members(data[int(bounds[taken]):], rel,
                                    pool=pool)
        yield from parts


def _entry_boundary(buf: bytes) -> int:
    """Position just past the last complete 4-line entry in buf, via
    newline count + up-to-4 rfind steps (C speed; a numpy scan over the
    whole chunk is ~50x slower on low-bandwidth hosts)."""
    c = buf.count(b"\n")
    if c < 4:
        return 0
    r = c % 4
    pos = len(buf)
    for _ in range(r + 1):
        pos = buf.rfind(b"\n", 0, pos)
    return pos + 1


def _cut_parts(parts: list, nl_counts: list):
    """Split accumulated parts at the last complete 4-line entry.
    Returns (batch_bytes_or_None, carry_parts, carry_nl_counts).  Only
    the boundary part is sliced; the batch is ONE join."""
    total_nl = sum(nl_counts)
    if total_nl < 4:
        return None, parts, nl_counts
    need = total_nl % 4 + 1  # newlines to walk back past, from the end
    for j in range(len(parts) - 1, -1, -1):
        if nl_counts[j] >= need:
            pos = len(parts[j])
            for _ in range(need):
                pos = parts[j].rfind(b"\n", 0, pos)
            boundary = pos + 1
            head = parts[: j] + [parts[j][:boundary]]
            tail_first = parts[j][boundary:]
            # tail keeps the need-1 newlines after the boundary newline
            carry = ([tail_first] if tail_first else []) + parts[j + 1:]
            carry_nl = ([need - 1] if tail_first else []) \
                + nl_counts[j + 1:]
            return b"".join(head), carry, carry_nl
        need -= nl_counts[j]
    return None, parts, nl_counts


def _batch_raw_bytes(path: str, target_bases: int,
                     pool: ThreadPoolExecutor) -> Iterator[bytes]:
    """Entry-aligned inflated FASTQ batches of ~target_bases sequence
    bases, assembled with exactly one byte-join per batch (the carry
    semantics of the reference reader, bionumpy/io/parser.py:160-165).
    The bases-per-raw-byte ratio is measured on the first part so
    batches fill their device bucket instead of padding ~30% of it."""
    return _batches_from_parts(_inflated_parts(path, pool), target_bases)


def _batches_from_parts(parts_iter: Iterator[bytes],
                        target_bases: int) -> Iterator[bytes]:
    """The generic accumulate/cut batching over any inflated-part
    stream (used directly for non-member files and as the fallback
    tail of the member-table fast path)."""
    parts, nl_counts = [], []
    total_bytes = 0
    target_raw = None
    for part in parts_iter:
        if not part:
            continue
        parts.append(part)
        nl_counts.append(part.count(b"\n"))
        total_bytes += len(part)
        if target_raw is None:
            seq_frac = max(_seq_fraction(part), 0.05)
            target_raw = max(int(target_bases / seq_frac), 1 << 16)
        if total_bytes >= target_raw:
            batch, parts, nl_counts = _cut_parts(parts, nl_counts)
            total_bytes = sum(map(len, parts))
            if batch:
                yield batch
    if parts:
        joined = b"".join(parts)
        if not joined.endswith(b"\n"):
            joined += b"\n"
        if joined.count(b"\n") % 4:
            raise ValueError("truncated FASTQ: incomplete final entry")
        yield joined

def _member_table(data: bytes):
    """(compressed bounds int64 (n+1,), raw sizes int64 (n,)) for a
    multi-member gzip byte string, from the ISIZE footer of each
    candidate member — or None when the file isn't cleanly multi-member
    (single member, implausible sizes).  Candidates are verified at
    inflate time; any mismatch falls back to the repairing path."""
    offsets = member_offsets(data)
    if len(offsets) < 2:
        return None
    arr = np.frombuffer(data, np.uint8)
    bounds = np.append(offsets, len(data))
    if np.any(np.diff(bounds) < 18):  # minimal gzip member is 18 bytes
        return None
    tails = bounds[1:]
    isz = (arr[tails - 4].astype(np.int64)
           | (arr[tails - 3].astype(np.int64) << 8)
           | (arr[tails - 2].astype(np.int64) << 16)
           | (arr[tails - 1].astype(np.int64) << 24))
    # Implausible expansion or empty members: not a clean member table.
    # The per-member bound caps what a corrupt/adversarial ISIZE footer
    # can make the slab allocator reserve (DEFLATE tops out ~1032x; real
    # FASTQ is <10x; the 64 KiB slack admits tiny high-ratio members) —
    # over the cap we take the repairing generic path instead of
    # np.empty'ing footer-dictated gigabytes.
    if np.any(isz <= 0) or \
            np.any(isz > 64 * np.diff(bounds) + (1 << 16)):
        return None
    return bounds, isz


def _inflate_member_into(data: bytes, start: int, end: int,
                         slab: np.ndarray, out_off: int,
                         expect: int) -> int:
    """Inflate one member into slab[out_off: out_off+expect]; returns
    the member's newline count (counted here, in the pool task, while
    the freshly written bytes are cache-warm — the batcher needs the
    count for entry-boundary cuts), or -1 if the member did not produce
    exactly `expect` verified bytes."""
    view = slab[out_off: out_off + expect]
    # fused inflate + CRC-verify + newline count: ONE read pass over
    # the fresh output instead of two (csrc gzip_inflate_count)
    fused = native.gzip_inflate_count_into(data, start, end, slab,
                                           out_off, expect, 10)
    if fused >= 0:
        return fused
    if native.gzip_inflate_into(data, start, end, slab, out_off, expect):
        return native.count_byte(view, 10, n_threads=1)
    # no native library: copying zlib fallback
    import zlib
    try:
        obj = zlib.decompressobj(wbits=31)
        out = obj.decompress(data[start:end])
        while not obj.eof:
            tail = obj.unconsumed_tail
            if not tail:
                return -1
            out += obj.decompress(tail)
        if obj.unused_data or len(out) != expect:
            return -1
    except zlib.error:
        return -1
    view[:] = np.frombuffer(out, np.uint8)
    return out.count(b"\n")


# headroom reserved at the front of every slab so the previous batch's
# partial-entry tail copies in without reallocating; entries larger
# than this take a rare concatenate fallback
_SLAB_PAD = 1 << 20

_READ_CHUNK = 4 << 20
_GZ_MAGIC = b"\x1f\x8b\x08"

# thread-local reusable inflate buffers for the fused member-parse path
_fuse_tls = threading.local()


def _fused_member_task(data, start: int, end: int, expect: int):
    """Inflate ONE gzip member into a thread-local buffer and parse it
    to packed words while its bytes are cache-warm — the raw slab never
    exists, cutting host memory passes from 3 to ~1.  Only valid for
    ENTRY-ALIGNED members (complete 4-line records): returns (packed u8,
    lengths i32, n_bases, nl) or None when the member fails any
    alignment/structure check (caller falls back to the slab path)."""
    buf = getattr(_fuse_tls, "buf", None)
    if buf is None or len(buf) < expect:
        buf = np.empty(max(expect, 1 << 20), np.uint8)
        _fuse_tls.buf = buf
    nl = native.gzip_inflate_count_into(data, start, end, buf, 0,
                                        expect)
    if nl < 0:
        return None
    return _parse_member(buf[:expect], nl)


def _parse_member(raw: np.ndarray, nl: int):
    """Validate + parse one member's raw bytes; None unless the member
    is a whole number of structurally valid 4-line entries."""
    if nl % 4 or len(raw) == 0 or raw[0] != 64 or raw[-1] != 10:
        return None
    try:
        packed, lengths, n_bases = native.fastq_parse_pack(
            raw, out_bytes=len(raw) // 4 + 16, n_threads=1)
    except ValueError:
        return None
    return packed, lengths, n_bases, nl


def _assemble_fused(outs):
    """Stitch per-member (packed, lengths, n_bases) into ONE bucketed
    batch: bit-shifted appends over PACKED data (0.25 B/base), the
    same (words, ends, n_bases, n_reads) contract as _parse_batch."""
    pad_words = 2 * (WORD_BASES // 4)
    n_bases = sum(o[2] for o in outs)
    bucket = bucket_size(max(n_bases, 1), 1 << 14)
    words_u8 = np.zeros(bucket // 4 + pad_words, np.uint8)
    with stage("stitch", n_bytes=n_bases // 4):
        off = 0
        for packed, _lengths, nb, _nl in outs:
            native.copy_2bit_shifted(packed, nb, words_u8, off)
            off += nb
        lengths = np.concatenate([o[1] for o in outs])
    ends = np.cumsum(lengths, dtype=np.int64).astype(np.int32)
    rows_bucket = bucket_size(max(len(ends), 1), 4096)
    if len(ends) < rows_bucket:
        pad = np.full(rows_bucket - len(ends),
                      ends[-1] if len(ends) else 0, np.int32)
        ends = np.concatenate([ends, pad])
    return words_u8.view(np.uint32), ends, n_bases, len(lengths)


class _OverlappedRead:
    """Background whole-file read into one buffer with a wait-for-
    offset API, so member inflation starts while later bytes are still
    coming off the filesystem instead of after one serialized up-front
    read."""

    def __init__(self, path: str):
        self.size = os.path.getsize(path)
        self.buf = bytearray(self.size)
        self._cond = threading.Condition()
        self._read = 0
        self._done = self.size == 0
        self._error = None
        self._thread = threading.Thread(target=carried(self._run),
                                        args=(path,), daemon=True)
        self._thread.start()

    def _run(self, path):
        try:
            with stage("read"), open(path, "rb") as f:
                mv = memoryview(self.buf)
                pos = 0
                while pos < self.size:
                    n = f.readinto(mv[pos: pos + _READ_CHUNK])
                    if n <= 0:
                        break
                    pos += n
                    with self._cond:
                        self._read = pos
                        self._cond.notify_all()
        except BaseException as e:  # surfaced on the consumer's wait
            self._error = e
        finally:
            with self._cond:
                self._done = True
                self._cond.notify_all()

    def wait_for(self, need: int) -> int:
        """Block until >= `need` bytes are read (or EOF); returns the
        bytes available."""
        with self._cond:
            while self._read < need and not self._done:
                self._cond.wait()
            if self._error is not None:
                raise self._error
            return self._read


class _MemberScanner:
    """Incremental gzip member-candidate scanner over a growing buffer:
    the same magic+FLG heuristic as io.pgzip.member_offsets, applied
    only to newly-read bytes (candidates are verified at inflate time
    exactly like the whole-buffer table)."""

    def __init__(self, buf: bytearray, size: int):
        self.buf = buf
        self.size = size
        self.cands = [0] if size >= 18 else []
        self._scan = 1  # next unscanned offset (candidate 0 implicit)
        self._scanned_end = size < 18

    def scan_to(self, limit: int):
        buf = self.buf
        lim = min(limit, self.size)
        if lim >= self.size:
            self._scanned_end = True
        last_valid = min(self.size - 18, lim - 4)
        prev = self.cands[-1] if self.cands else -1
        i = buf.find(_GZ_MAGIC, self._scan, lim)
        while 0 <= i <= last_valid:
            if i > prev and not (buf[i + 3] & 0xE0):
                self.cands.append(i)
                prev = i
            i = buf.find(_GZ_MAGIC, i + 1, lim)
        # keep a small overlap so a magic/FLG spanning the read
        # frontier is found on the next call
        self._scan = max(self._scan, max(1, min(lim - 2,
                                                last_valid + 1)))

    @property
    def exhausted(self) -> bool:
        # scan_to caps _scan below size-2 for files >= ~18 bytes, so
        # test the explicit saw-the-end flag instead of the offset
        return self._scanned_end


def _tail_entry_cut(view: np.ndarray, n_newlines: int) -> int:
    """Position just past the last complete 4-line entry of `view`,
    given its total newline count (the backward twin of
    _entry_boundary, scanning only the tail instead of counting)."""
    if n_newlines < 4:
        return 0
    need = n_newlines % 4 + 1
    end = len(view)
    win = 1 << 16
    while end > 0:
        lo = max(0, end - win)
        pos = np.flatnonzero(view[lo:end] == 10)
        if len(pos) >= need:
            return int(pos[len(pos) - need]) + lo + 1
        need -= len(pos)
        end = lo
        win *= 2
    return 0


def _batch_arrays(path: str, target_bases: int, pool: ThreadPoolExecutor,
                  fused_parse: bool = True):
    """Fast ingest: yield entry-aligned inflated FASTQ batches as uint8
    arrays (member-table path) or bytes (generic carry path).  With
    `fused_parse` and the host library loaded, ENTRY-ALIGNED member
    layouts short-circuit to pre-parsed (words, ends, n_bases, n_reads)
    tuples (the _parse_batch contract) built member-by-member while
    cache-warm; any misaligned member drops the file back to the raw slab
    path.  The device-parse transport passes fused_parse=False: it wants
    the raw bytes.

    Multi-member gzip (pigz-style output, the common case for large
    FASTQ) carries each member's raw size in its ISIZE footer, so the
    generator can group members into ~target-sized batches and inflate
    every member IN PARALLEL directly into one preallocated slab per
    batch — no per-batch byte join and no per-part newline counting
    (one threaded native count per slab instead), ~2x less host memory
    traffic than the generic path.
    Batches still cut on ENTRY boundaries: the partial-entry tail after
    the last complete entry is copied into the next slab's headroom
    (members need not be record-aligned).  Any anomaly (false-positive
    member boundary, ISIZE/CRC mismatch) makes the generator fall back
    to the generic repairing path for the REMAINDER of the file, so
    consumers never restart."""
    if not path.endswith(".gz"):
        yield from _batch_raw_bytes(path, target_bases, pool)
        return
    ovr = _OverlappedRead(path)
    data = ovr.buf
    scanner = _MemberScanner(data, ovr.size)

    def ensure_members(k: int):
        """Scan forward until >= k member candidates are known or the
        whole file has been scanned."""
        while len(scanner.cands) < k and not scanner.exhausted:
            got = ovr.wait_for(min(ovr.size, scanner._scan + _READ_CHUNK))
            scanner.scan_to(got)
            if got >= ovr.size:
                break

    def fall_back_all():
        ovr.wait_for(ovr.size)
        yield from _generic_tail(bytes(data), 0, target_bases, pool)

    ensure_members(2)
    cands = scanner.cands
    # The member-batch path cannot split WITHIN a member, so a file
    # that is one big member must take the generic target-sized
    # splitting path (a 400MB single-member gzip would otherwise
    # become ONE device batch — 16x the designed sort working set).  A
    # single SMALL member (compressed size well under a batch) keeps
    # the fused inflate+parse path.  No candidates at all (tiny or
    # non-gzip-shaped file) also falls back.
    if scanner.exhausted and len(cands) < 2 and (
            not cands or ovr.size > max(target_bases // 2, 1 << 20)):
        yield from fall_back_all()
        return

    def member_end(i: int) -> int:
        """End offset of member i; scans further as needed.  The final
        member ends at the file size (requires read completion)."""
        ensure_members(i + 2)
        if i + 1 < len(scanner.cands):
            return scanner.cands[i + 1]
        ovr.wait_for(ovr.size)
        return ovr.size

    def isize_at(end: int) -> int:
        """The ISIZE footer of the member ending at `end`."""
        return int.from_bytes(data[end - 4: end], "little")

    def plausible(start: int, end: int, raw: int) -> bool:
        # same bounds as _member_table: minimal 18-byte members and a
        # capped expansion ratio (the slab-allocation guard)
        return end - start >= 18 and 0 < raw <= \
            64 * (end - start) + (1 << 16)

    # bases-per-raw-byte from member 0 (sizes the member groups so
    # batches fill their device bucket)
    end0 = member_end(0)
    isz0 = isize_at(end0)
    if not plausible(0, end0, isz0):
        yield from fall_back_all()
        return
    ovr.wait_for(end0)
    first = np.empty(isz0, np.uint8)
    first_nl = _inflate_member_into(data, 0, end0, first, 0, isz0)
    if first_nl < 0:
        yield from fall_back_all()
        return
    frac = max(_seq_fraction(first.tobytes()), 0.05)
    target_raw = max(int(target_bases / frac), 1 << 16)

    carry = None   # partial-entry tail of the previous slab (ndarray)
    carry_nl = 0   # newlines inside carry
    a = 0
    a_start = 0
    bad = False    # implausible member seen: fall back from member a
    use_fused = fused_parse and native._load() is not None
    while True:
        # collect the group [a, b): members until target_raw raw bytes
        group = []     # (start, end, isize, raw offset in group)
        raw_sum = 0
        start = a_start
        while raw_sum < target_raw:
            i = a + len(group)
            if i + 1 < len(scanner.cands):
                end = scanner.cands[i + 1]
            else:
                ensure_members(i + 2)
                if i >= len(scanner.cands):
                    break  # past the last member
                if i + 1 < len(scanner.cands):
                    end = scanner.cands[i + 1]
                else:  # final member: ends at the file end
                    ovr.wait_for(ovr.size)
                    end = ovr.size
            raw = isize_at(end)
            if not plausible(start, end, raw):
                bad = True
                break
            group.append((start, end, raw, raw_sum))
            raw_sum += raw
            start = end
            if end >= ovr.size:
                break
        def repair_from(start_byte: int):
            """Anomaly at/after start_byte: hand the remainder (plus
            the carried tail) to the repairing generic path."""
            ovr.wait_for(ovr.size)
            parts = _inflated_parts_from(bytes(data), pool, start_byte)
            if carry is not None and len(carry):
                from itertools import chain
                parts = chain([carry.tobytes()], parts)
            return _batches_from_parts(parts, target_bases)

        if bad:  # implausible member header/footer: don't touch it
            yield from repair_from(a_start)
            return
        if not group:
            break
        b = a + len(group)
        if use_fused and (carry is None or len(carry) == 0):
            ovr.wait_for(group[-1][1])
            with stage("inflate+parse",
                       n_bytes=group[-1][1] - group[0][0]):
                futs = [
                    pool.submit(_parse_member, first, first_nl)
                    if (idx == 0 and a == 0) else
                    pool.submit(_fused_member_task, data, s, e, r)
                    for idx, (s, e, r, _off) in enumerate(group)]
                outs = [f.result() for f in futs]
            if all(o is not None for o in outs):
                yield _assemble_fused(outs)
                a = b
                a_start = group[-1][1]
                if a_start >= ovr.size:
                    return
                continue
            # a member isn't entry-aligned (pigz-style layout): use
            # the raw slab path from here on
            use_fused = False
        slab = np.empty(_SLAB_PAD + raw_sum, np.uint8)
        ovr.wait_for(group[-1][1])  # all group bytes on hand
        with stage("inflate", n_bytes=group[-1][1] - group[0][0]):
            def _task(entry, idx):
                m_start, m_end, m_raw, m_off = entry
                if idx == 0 and a == 0:  # reuse the probe
                    slab[_SLAB_PAD: _SLAB_PAD + len(first)] = first
                    return first_nl
                return _inflate_member_into(
                    data, m_start, m_end, slab, _SLAB_PAD + m_off,
                    m_raw)
            futs = [pool.submit(_task, entry, idx)
                    for idx, entry in enumerate(group)]
            counts = [f.result() for f in futs]
        if min(counts) < 0:  # verify mismatch inside the group
            yield from repair_from(a_start)
            return
        c_len = len(carry) if carry is not None else 0
        if c_len > _SLAB_PAD:  # giant entry: rare concatenate fallback
            slab = np.concatenate([carry, slab[_SLAB_PAD:]])
            content = slab
        else:
            if c_len:
                slab[_SLAB_PAD - c_len: _SLAB_PAD] = carry
            content = slab[_SLAB_PAD - c_len:]
        nl = carry_nl + sum(counts)
        cut = _tail_entry_cut(content, nl)
        carry = content[cut:].copy()
        carry_nl = nl % 4 if cut else nl
        if cut:
            yield content[:cut]
        a = b
        a_start = group[-1][1]
        if a_start >= ovr.size:
            break
    if carry is not None and len(carry):
        if carry[-1] != 10:
            carry = np.append(carry, np.uint8(10))
            carry_nl += 1
        if carry_nl % 4:
            raise ValueError("truncated FASTQ: incomplete final entry")
        yield carry


def _generic_tail(data: bytes, start: int, target_bases: int,
                  pool: ThreadPoolExecutor) -> Iterator[bytes]:
    """Generic carry batching over data[start:] with the streaming
    repairing member inflater (the fallback when the member-table fast
    path can't be trusted)."""
    # raw FASTQ bytes per base ~= 1/seq_frac (2-3x); cap parts near
    # the target so single-member whole-inflate batches honor it
    part_bytes = min(_PART_BYTES, max(target_bases * 3, 1 << 20))
    yield from _batches_from_parts(
        _inflated_parts_from(data, pool, start, part_bytes),
        target_bases)


def _seq_fraction(chunk: bytes) -> float:
    """Fraction of raw FASTQ bytes that are sequence bases, from the
    first complete entries of a chunk."""
    head = chunk[: 1 << 20]
    end = _entry_boundary(head)
    if end == 0:
        return 0.5
    sample = head[:end]
    arr = np.frombuffer(sample, np.uint8)
    nl = np.flatnonzero(arr == 10)
    starts = np.insert(nl[:-1] + 1, 0, 0)
    seq_bytes = int((nl[1::4] - starts[1::4]).sum())
    return seq_bytes / max(len(sample), 1)


def _prefetched(gen: Iterator, depth: int = 2) -> Iterator:
    """Run a generator on a background thread with a bounded queue so
    producing (inflate) overlaps the consumer's device dispatch/fetch."""
    import queue
    q = queue.Queue(maxsize=depth)
    _END = object()

    def run():
        try:
            for item in gen:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    t = threading.Thread(target=carried(run), daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _parse_batch(raw) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(bucketed packed words uint32, ends int32, n_bases, n_reads).
    `raw` is a complete-entry FASTQ batch: bytes or a uint8 array —
    or already that tuple (the fused ingest path pre-parses)."""
    if isinstance(raw, tuple):
        return raw
    pad_words = 2 * (WORD_BASES // 4)
    if len(raw) == 0:  # empty batch
        n_bytes = (1 << 14) // 4 + pad_words
        return (np.zeros(n_bytes, np.uint8).view(np.uint32),
                np.zeros(4096, np.int32), 0, 0)
    with stage("parse+pack", n_bytes=len(raw)):
        arr = raw if isinstance(raw, np.ndarray) \
            else np.frombuffer(raw, np.uint8)
        # bases < half the raw bytes (the quality line mirrors the
        # sequence), so parsing straight into an upper-bound bucket and
        # slicing to the true one afterwards never copies the packed
        # words (native zero-fills the whole output)
        ub_bucket = bucket_size(max(len(arr) // 2, 1), 1 << 14)
        packed, lengths, n_bases = native.fastq_parse_pack(
            arr, out_bytes=ub_bucket // 4 + pad_words)
        bucket = bucket_size(max(n_bases, 1), 1 << 14)
        out = packed[: bucket // 4 + pad_words]
        ends = np.cumsum(lengths, dtype=np.int64).astype(np.int32)
        # pad the row axis into a power-of-two bucket too (repeating the
        # final end is a no-op for the validity scatters) so every batch
        # shares one compiled program instead of one per row count
        rows_bucket = bucket_size(max(len(ends), 1), 4096)
        if len(ends) < rows_bucket:
            pad = np.full(rows_bucket - len(ends),
                          ends[-1] if len(ends) else 0, np.int32)
            ends = np.concatenate([ends, pad])
    return out.view(np.uint32), ends, n_bases, len(lengths)


def _pad_raw_batch(raw):
    """Device-parse transport: raw bytes (or a uint8 array) zero-padded
    into a power-of-two bucket; returns (padded, true length)."""
    with stage("pad", n_bytes=len(raw)):
        bucket = bucket_size(max(len(raw), 1), 1 << 14)
        padded = np.zeros(bucket, np.uint8)
        padded[: len(raw)] = raw if isinstance(raw, np.ndarray) \
            else np.frombuffer(raw, np.uint8)
    return padded, len(raw)


def _make_acc(acc_cap: int, device):
    """Empty accumulator: acc_cap sentinel keys with zero counts, and
    its live-row count as a device scalar."""
    return (torch.full((acc_cap,), SENTINEL, dtype=torch.int64,
                       device=device),
            torch.zeros(acc_cap, dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def _fold_program_impl(acc, tables, acc_cap: int):
    """Merge batch tables into the accumulator.  acc is (keys, counts,
    n_live); tables are (keys, counts) pairs.  Returns the new acc."""
    keys = torch.cat([acc[0]] + [t[0] for t in tables])
    cnt = torch.cat([acc[1]] + [t[1] for t in tables])
    return merge_hash_tables(keys, cnt, acc_cap)


# device meta accumulator, int64 (5,): the JAX package's (8,) uint32
# [max_unique, kmers_lo, kmers_hi, n_entries, ok, bases_lo, bases_hi,
# spare] with each carry pair joined and the spare dropped
META_FIELDS = ("max_unique", "n_kmers", "n_entries", "ok", "n_bases")


def _meta_init(device) -> torch.Tensor:
    meta = torch.zeros(len(META_FIELDS), dtype=torch.int64, device=device)
    meta[META_FIELDS.index("ok")] = 1
    return meta


def _meta_add_packed(meta_acc: torch.Tensor, meta: torch.Tensor) -> None:
    """Fold a packed batch's (2,) [n_unique, n_valid] into the meta
    accumulator, in place and on the device."""
    meta_acc[:2] = torch.stack([torch.maximum(meta_acc[0], meta[0]),
                                meta_acc[1] + meta[1]])


def _meta_add_device(meta_acc: torch.Tensor, meta: torch.Tensor) -> None:
    """Fold a device-parse batch's (5,) [n_unique, n_valid, n_entries, ok,
    n_bases] into the meta accumulator, in place and on the device: ok
    folds as a minimum."""
    _meta_add_packed(meta_acc, meta[:2])
    meta_acc[2:] = torch.stack([meta_acc[2] + meta[2],
                                torch.minimum(meta_acc[3], meta[3]),
                                meta_acc[4] + meta[4]])


class AccOverflow(ValueError):
    """Accumulator has >= acc_cap distinct rows.  Carries the fetched
    meta vector so callers can tell "a batch overflowed its cap
    (self-heal by rerunning at a bigger cap)" from "acc_cap genuinely
    too small"."""

    def __init__(self, acc_cap, meta_h):
        super().__init__(
            f"accumulator overflow: >= {acc_cap} distinct k-mers; "
            f"raise acc_cap")
        self.meta_h = meta_h


def _fetch_acc(acc, acc_cap: int, meta_dev: torch.Tensor = None):
    """Copy the accumulator's live rows to the host: one small copy of
    the live count (with the meta accumulator, when given), then the
    live (key, count) rows in ONE copy.  Returns (hashes uint64, counts
    int64), plus the host meta vector when `meta_dev` is given."""
    keys, cnt, nu_dev = acc
    probe = nu_dev.reshape(1) if meta_dev is None else \
        torch.cat([nu_dev.reshape(1), meta_dev])
    with stage("D2H-meta", device=probe.is_cuda):
        probe = probe.cpu().numpy()
    nu = int(probe[0])
    meta_h = None if meta_dev is None else probe[1:]
    if nu >= acc_cap:
        raise AccOverflow(acc_cap, meta_h)
    table = fetch_rows(keys[:nu], cnt[:nu], rows=nu)
    hashes, counts = table[:nu].view(np.uint64), table[nu:]
    if meta_dev is None:
        return hashes, counts
    return hashes, counts, meta_h


def _checked_mesh(mesh, device) -> Mesh:
    """The caller's mesh: a parallel.Mesh, with `device` (when given)
    its lead device."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a bionumpy_tpu_torch.parallel Mesh "
                        f"(parallel.create_mesh), got {type(mesh).__name__}")
    if device is not None:
        dev, lead = torch.device(device), mesh.lead
        if dev.type != lead.type or (dev.index or 0) != (lead.index or 0):
            raise ValueError(f"device={device!r} is not the mesh's lead "
                             f"device {lead}")
    return mesh


def _split_fastq_entries(raw: bytes, n: int):
    """Split a complete-entry FASTQ byte blob into n pieces on entry
    boundaries (C-speed find/count; empty tail pieces allowed) — the
    per-batch shard split for the mesh path."""
    bounds = [0]
    c_before = 0  # newlines before bounds[-1]
    prev = 0
    for i in range(1, n):
        p = len(raw) * i // n
        if p <= bounds[-1]:
            bounds.append(bounds[-1])
            continue
        c = c_before + raw.count(b"\n", prev, p)
        # advance p to the next entry start: after a newline, with the
        # cumulative newline count a multiple of 4
        if p and raw[p - 1: p] != b"\n":
            nl = raw.find(b"\n", p)
            if nl < 0:
                p = len(raw)
            else:
                p = nl + 1
                c += 1
        while p < len(raw) and c % 4:
            nl = raw.find(b"\n", p)
            if nl < 0:
                p = len(raw)
                break
            p = nl + 1
            c += 1
        prev = p
        c_before = c
        bounds.append(p)
    bounds.append(len(raw))
    return [raw[bounds[i]: bounds[i + 1]] for i in range(n)]


def _sharded_batches(path: str, target_bases: int, n_dev: int,
                     pool: ThreadPoolExecutor):
    """Yield per-batch shard-stacked (words (n_dev, W), ends (n_dev, R),
    n_true (n_dev,), parsed) for the mesh pipelines: inflated batches of
    ~target_bases * n_dev bases split on entry boundaries, each shard
    native-parsed+packed, padded to the widest shard of the batch."""
    for raw in _prefetched(_batch_arrays(path, target_bases * n_dev, pool,
                                         fused_parse=False)):
        if isinstance(raw, np.ndarray):
            raw = raw.tobytes()
        shards = _split_fastq_entries(raw, n_dev)
        parsed = [_parse_batch(s) for s in shards]
        n_words = max(p[0].shape[0] for p in parsed)
        n_rows = max(p[1].shape[0] for p in parsed)
        words = np.zeros((n_dev, n_words), np.uint32)
        ends = np.zeros((n_dev, n_rows), np.int32)
        n_true = np.zeros(n_dev, np.int32)
        for d, (w, e, nb, nr) in enumerate(parsed):
            words[d, : w.shape[0]] = w
            ends[d, : e.shape[0]] = e
            ends[d, e.shape[0]:] = e[-1] if e.shape[0] else 0
            n_true[d] = nb
        yield words, ends, n_true, parsed


def _mesh_batch(mesh: Mesh, words, ends, in_flight: deque = None):
    """One batch's shards on their devices (words as int32).  With
    `in_flight`, the host waits while _IN_FLIGHT earlier batches are
    unfinished (_mesh_batch_done records them)."""
    with stage("H2D", n_bytes=words.nbytes + ends.nbytes,
               device=mesh.lead.type == "cuda"):
        shards = (put_sharded(mesh, words.view(np.int32)),
                  put_sharded(mesh, ends))
    while in_flight and len(in_flight) >= _IN_FLIGHT:
        with stage("backpressure"):
            in_flight.popleft()[0].synchronize()
    return shards


def _mesh_batch_done(mesh: Mesh, in_flight: deque, *host_arrays) -> None:
    """The copies read the host arrays asynchronously: keep them until the
    lead device has finished the batch's step."""
    if mesh.lead.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(mesh.lead))
        in_flight.append((event, host_arrays))


def _mesh_fold_job(path: str, step, mesh: Mesh, target_bases: int,
                   n_threads, acc_cap: int, check=None):
    """Stream the file's batches through a mesh fold step into an
    accumulator on the lead device and fetch it once; `check(n_reads,
    n_bases)` runs after every batch.  Returns ((hashes, counts, host
    meta dict), n_reads, n_bases), the table None when the file holds no
    batch."""
    n_dev = int(mesh.devices.size)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    keys, cnt, acc_nu = _make_acc(acc_cap, mesh.lead)
    acc = (keys, cnt)
    meta_acc = _meta_init(mesh.lead)
    in_flight = deque()
    n_reads = n_bases = n_batches = 0
    pool = ThreadPoolExecutor(n_threads)
    try:
        for words, ends, n_true, parsed in _sharded_batches(
                path, target_bases, n_dev, pool):
            n_reads += sum(p[3] for p in parsed)
            n_bases += sum(p[2] for p in parsed)
            words_d, ends_d = _mesh_batch(mesh, words, ends, in_flight)
            with stage("mesh-step", device=mesh.lead.type == "cuda"):
                acc, meta_acc, acc_nu = step(acc, meta_acc, words_d, ends_d,
                                             [int(n) for n in n_true])
            _mesh_batch_done(mesh, in_flight, words, ends)
            n_batches += 1
            if check is not None:
                check(n_reads, n_bases)
    finally:
        pool.shutdown(wait=False)
    if n_batches == 0:
        return None, 0, 0
    with stage("D2H-table"):
        hashes, counts, meta_h = _fetch_acc((*acc, acc_nu), acc_cap,
                                            meta_acc)
    meta = dict(zip(META_FIELDS, (int(v) for v in meta_h)))
    return (hashes, counts, meta), n_reads, n_bases


def _too_many_kmers():
    return ValueError("job exceeds 2^31 k-mers: use the single-device path "
                      "(it spills to a host int64 table) or split the input")


def _count_kmers_fastq_mesh(path: str, k: int, cap: int,
                            target_bases: int, mesh: Mesh, n_threads,
                            acc_cap):
    """Data-parallel count_kmers_fastq: per-batch read shards counted on
    every mesh device, tables gathered and merged into an accumulator on
    the lead device in ONE step per batch (the reference's only analog
    is the sequential chunk fold, reference:
    bionumpy/streams/reductions.py:6-23 + bionumpy/io/parser.py:173-178)."""
    if acc_cap is None:
        acc_cap = max(4 * cap, 1 << 22)
    step = sharded_sparse_count_fold_step(mesh, k, cap, acc_cap)

    def check(n_reads, n_bases):
        # doomed-job guard, host-side and mid-stream: kmers <= bases -
        # (k-1)*reads.  The JAX package's mesh accumulator has int32
        # counts and cannot spill; the port keeps its bound, so the same
        # inputs raise the same error
        if n_bases - (k - 1) * n_reads > _SPILL_LIMIT:
            raise _too_many_kmers()

    table, n_reads, n_bases = _mesh_fold_job(
        path, step, mesh, target_bases, n_threads, acc_cap, check)
    if table is None:
        stats = {"n_reads": 0, "n_bases": 0, "n_kmers": 0}
        return SparseEncodedCounts(
            KmerEncoding(DNAEncoding, k), np.empty(0, np.uint64),
            np.empty(0, np.int64)), stats
    hashes, counts, meta = table
    if meta["max_unique"] > cap:
        new_cap = 1 << (meta["max_unique"] - 1).bit_length()
        add("cap-rerun", 0.0)
        logger.warning(
            "count_kmers_fastq(mesh): shard table overflow (%d > "
            "cap=%d); rerunning at cap=%d", meta["max_unique"], cap,
            new_cap)
        # never shrink the (possibly explicit) acc_cap on rerun
        return _count_kmers_fastq_mesh(path, k, new_cap, target_bases,
                                       mesh, n_threads,
                                       max(acc_cap, 4 * new_cap))
    if meta["n_kmers"] > _SPILL_LIMIT:
        raise _too_many_kmers()
    stats = {"n_reads": n_reads, "n_bases": n_bases,
             "n_kmers": meta["n_kmers"]}
    return SparseEncodedCounts(KmerEncoding(DNAEncoding, k), hashes,
                               counts), stats


@call_span
def count_kmers_fastq(path: str, k: int = 31, cap: int = 1 << 20,
                      target_bases: int = TARGET_BUCKET - (1 << 21),
                      device=None, n_threads: int = None,
                      device_parse="auto", acc_cap: int = None,
                      mesh=None, spill_windows: int = None):
    """Count all k-mers (1 <= k <= 31) of a FASTQ file, plain or
    (multi-member) gzip, overlapping host inflate/parse with device
    counting.

    `device`: None is the card ("cuda"), which must be present; pass
    "cpu" to run the kernels' plain versions on the host.
    `device_parse` selects the transport: False (or "packed") parses on
    the host and ships 2-bit-packed words (0.25 B/base); True (or
    "device") ships the raw inflated bytes and scans, encodes and packs
    them on the device (ops/parse.py); "auto" runs batch 0 packed and
    batch 1 on the device, waits for each, and keeps the faster.  Entry-
    aligned gzip members arrive parsed by the host either way, except
    with True/"device".
    `cap` bounds the distinct k-mers of one batch's table; a batch that
    overflows it makes the whole job rerun once at a cap that fits.
    `acc_cap` bounds the distinct k-mers held in the device accumulator
    (default max(4*cap, 2^22)); AccOverflow is raised when the job has
    that many or more.  `spill_windows` fetches the accumulator into a
    host table every that many folds.  A malformed batch on the device
    transport raises ValueError at the end of the job.
    `mesh=` (a parallel.Mesh) splits each batch on read boundaries over
    the mesh's devices, counts every shard there and merges the shard
    tables into an accumulator on the lead device, one step a batch
    (parallel/sparse_parallel.sharded_sparse_count_fold_step); it ships
    packed words (device_parse does not apply) and ignores
    spill_windows, as the JAX package's mesh path does.  `device`, when
    given with a mesh, must be the mesh's lead device.

    Returns a SparseEncodedCounts over the DNA k-mer encoding plus a
    stats dict {n_reads, n_bases, n_kmers}."""
    transports = {"auto": None, True: "device", False: "packed",
                  "device": "device", "packed": "packed"}
    if device_parse not in transports:
        raise ValueError(f"device_parse must be one of {list(transports)}, "
                         f"got {device_parse!r}")
    modes = transports[device_parse]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must lie in 1..{MAX_K}, got {k}")
    if mesh is not None:
        return _count_kmers_fastq_mesh(path, k, cap, target_bases,
                                       _checked_mesh(mesh, device),
                                       n_threads, acc_cap)
    device = resolve_device(device)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    acc_cap_arg = acc_cap
    if acc_cap is None:
        acc_cap = max(4 * cap, 1 << 22)
    on_card = device.type == "cuda"
    lut_d = torch.from_numpy(DNAEncoding.lookup_table).to(device)

    acc = _make_acc(acc_cap, device)
    meta_acc = _meta_init(device)
    pending = []        # device (keys, counts) tables awaiting a fold
    in_flight = deque()  # (event, host arrays) per batch
    spilled = (np.empty(0, np.uint64), np.empty(0, np.int64))
    n_reads = n_bases = n_batches = 0
    any_device_parse = False
    kmers_in_acc = 0    # host-side UPPER BOUND (bases >= kmers)
    n_folds = 0
    last_spill_fold = -1

    def hold(*host_arrays):
        """The asynchronous copies read the host arrays: keep them alive
        until the batch's work has completed, and block on batches
        _IN_FLIGHT launches old."""
        if on_card:
            event = torch.cuda.Event()
            event.record()
            in_flight.append((event, host_arrays))
            while len(in_flight) > _IN_FLIGHT:
                with stage("backpressure"):
                    in_flight.popleft()[0].synchronize()

    def count_packed(words, ends, nb):
        """Launch one batch's table; its meta folds into the device meta
        accumulator.  Nothing waits for the device here except the
        bounded backpressure."""
        with stage("H2D", n_bytes=words.nbytes + ends.nbytes,
                   device=on_card):
            words_d = torch.from_numpy(words.view(np.int32)).to(
                device, non_blocking=True)
            ends_d = torch.from_numpy(ends).to(device, non_blocking=True)
        with stage("dispatch", device=on_card):
            keys, cnt, meta = kmer_sentinel_table_packed(
                words_d, ends_d, k, nb, cap)
            _meta_add_packed(meta_acc, meta)
        hold(words, ends)
        return keys, cnt

    def count_device_parse(padded, n_true):
        """The device-parse twin of count_packed: the raw bytes go over,
        and the scan waits once for the device to learn the batch's base
        count (ops/parse.py)."""
        with stage("H2D", n_bytes=padded.nbytes, device=on_card):
            raw_d = torch.from_numpy(padded).to(device, non_blocking=True)
        with stage("dispatch", device=on_card):
            table, meta = fastq_to_sparse_kmer_table(
                raw_d, lut_d, n_true, padded.shape[0] // 16, k, cap)
            _meta_add_device(meta_acc, meta)
        hold(padded)
        return table

    def fold_pending(force=False):
        """Fold ACC_FOLD pending tables into the accumulator (all of
        them when `force`)."""
        nonlocal acc, n_folds
        while len(pending) >= ACC_FOLD or (force and pending):
            batch = pending[:ACC_FOLD]
            del pending[:ACC_FOLD]
            with stage("device-fold", device=on_card):
                acc = _fold_program_impl(acc, batch, acc_cap)
            n_folds += 1

    def spill_acc():
        """Fetch the accumulator and fold it into the host table."""
        nonlocal acc, spilled, kmers_in_acc
        fold_pending(force=True)
        with stage("D2H-spill"):
            h, c = _fetch_acc(acc, acc_cap)
        spilled = merge_sorted_tables(*spilled, h, c)
        acc = _make_acc(acc_cap, device)
        kmers_in_acc = 0

    def launch(prepped):
        nonlocal n_reads, n_bases, n_batches, kmers_in_acc, \
            last_spill_fold, any_device_parse
        mode, payload = prepped
        if mode == "packed":
            words, ends, nb, nr = payload
            table = count_packed(words, ends, nb)
            n_bases += nb
            n_reads += nr
            bound = nb
        else:
            padded, n_true = payload
            table = count_device_parse(padded, n_true)
            bound = int(padded.shape[0])  # k-mers <= raw batch bytes
            any_device_parse = True
        n_batches += 1
        if kmers_in_acc + bound > _SPILL_LIMIT:
            spill_acc()
        kmers_in_acc += bound
        pending.append(table)
        fold_pending()
        if spill_windows and n_folds > last_spill_fold \
                and n_folds % spill_windows == 0:
            # overlap spill: fetch the accumulator mid-stream, so the
            # final transfer only covers k-mers first seen since
            last_spill_fold = n_folds
            spill_acc()
        if modes is None and n_batches <= 2 and on_card:
            # the "auto" probe times each mode's real throughput: without
            # a wait the asynchronous launch times only the enqueue
            torch.cuda.synchronize(device)

    def prep(mode, raw):
        if isinstance(raw, tuple):  # fused ingest: already parsed
            return "packed", raw
        if mode == "packed":
            return mode, _parse_batch(raw)
        return mode, _pad_raw_batch(raw)

    def mode_for(i):
        if modes is not None:
            return modes
        return "packed" if i != 1 else "device"

    batch_times = {}
    pool = ThreadPoolExecutor(n_threads)
    worker = ThreadPoolExecutor(1)
    try:
        # the worker prepares batch i+1 while batch i launches
        batches = _prefetched(_batch_arrays(
            path, target_bases, pool, fused_parse=(modes != "device")))
        prep_fut = None
        chosen = modes
        i = 0
        t_mark = time.perf_counter()
        for raw in batches:
            if prep_fut is not None:
                prepped = prep_fut.result()
                prep_fut = worker.submit(carried(prep),
                                         chosen or mode_for(i + 1), raw)
                launch(prepped)
                now = time.perf_counter()
                batch_times[prepped[0]] = min(
                    batch_times.get(prepped[0], 9e9), now - t_mark)
                t_mark = now
                i += 1
                if chosen is None and i >= 2:
                    chosen = min(batch_times, key=batch_times.get)
            else:
                prep_fut = worker.submit(carried(prep), mode_for(i), raw)
        if prep_fut is not None:
            launch(prep_fut.result())
    finally:
        worker.shutdown(wait=False)
        pool.shutdown(wait=False)
    logger.info("count_kmers_fastq: %d batches; transport %s; fastest "
                "batch (s) by transport %s", n_batches, chosen, batch_times)

    if n_batches == 0:
        stats = {"n_reads": n_reads, "n_bases": n_bases, "n_kmers": 0}
        return SparseEncodedCounts(
            KmerEncoding(DNAEncoding, k), np.empty(0, np.uint64),
            np.empty(0, np.int64)), stats

    def rerun(max_unique):
        # a batch's distinct k-mers overflowed its (truncated) table:
        # redo the whole job ONCE at a cap that fits (the meta carries
        # the true per-batch distinct count, so one rerun suffices)
        new_cap = 1 << (max_unique - 1).bit_length()
        add("cap-rerun", 0.0)
        logger.warning(
            "count_kmers_fastq: batch table overflow (%d > cap=%d); "
            "rerunning at cap=%d", max_unique, cap, new_cap)
        # an explicit caller acc_cap is kept, but never below what the
        # new cap derives
        new_acc_cap = None if acc_cap_arg is None else \
            max(acc_cap_arg, 4 * new_cap)
        return count_kmers_fastq(
            path, k, cap=new_cap, target_bases=target_bases,
            device=device, n_threads=n_threads, device_parse=device_parse,
            acc_cap=new_acc_cap, spill_windows=spill_windows)

    with stage("device-merge", device=on_card):
        fold_pending(force=True)
    try:
        with stage("D2H-table"):
            hashes, counts, meta_h = _fetch_acc(acc, acc_cap, meta_acc)
    except AccOverflow as e:
        # a batch-cap overflow can drive the accumulator past acc_cap
        # too: the self-healing rerun must win over the hard error
        if int(e.meta_h[0]) > cap:
            return rerun(int(e.meta_h[0]))
        raise
    meta = dict(zip(META_FIELDS, (int(v) for v in meta_h)))
    if any_device_parse:
        if not meta["ok"]:
            raise ValueError("malformed FASTQ batch (device scan)")
        n_reads += meta["n_entries"]
        n_bases += meta["n_bases"]
    if meta["max_unique"] > cap:
        return rerun(meta["max_unique"])
    if len(spilled[0]):
        hashes, counts = merge_sorted_tables(*spilled, hashes, counts)
    stats = {"n_reads": n_reads, "n_bases": n_bases,
             "n_kmers": meta["n_kmers"]}
    return SparseEncodedCounts(KmerEncoding(DNAEncoding, k), hashes,
                               counts), stats


@call_span
def get_motif_matches_fastq(path: str, pwm, threshold: float,
                            cap: int = 1 << 20,
                            target_bases: int = TARGET_BUCKET - (1 << 21),
                            device=None, n_threads: int = None, mesh=None):
    """Whole-job PWM motif scan of a FASTQ file, plain or (multi-member)
    gzip: every window of every read is scored on the device, and the
    positions scoring above `threshold` (in float32) whose window stays
    inside its read are compacted there, so the host fetches the matches
    and not the scores.

    `pwm`: a PWM, or a (4, w) matrix over ACGT, w <= 32.  `device`: None
    is the card ("cuda"), which must be present; pass "cpu" to run the
    kernel's plain version on the host.  `cap` bounds the matches of one
    batch: a batch with more raises ValueError.  `mesh=` (a
    parallel.Mesh) splits each batch on read boundaries over the mesh's
    devices, scans and compacts every shard there and fetches each
    shard's matches (parallel/sparse_parallel.sharded_pwm_match_step);
    `cap` then bounds a shard's matches, and `device`, when given, must
    be the mesh's lead device.

    Returns (read indices, in-read offsets, stats {n_reads, n_bases,
    n_matches}), sorted by (read, offset); equal to the JAX package's
    get_motif_matches_fastq on the same file."""
    matrix = pwm.matrix if hasattr(pwm, "matrix") else np.asarray(pwm)
    matrix32 = np.ascontiguousarray(matrix, np.float32)
    if matrix32.ndim != 2 or matrix32.shape[0] != 4:
        raise ValueError(f"the motif scan needs a (4, w) matrix over ACGT, "
                         f"got shape {matrix32.shape}")
    w = matrix32.shape[1]
    if mesh is not None:
        return _motif_matches_fastq_mesh(path, matrix32, threshold, cap,
                                         target_bases,
                                         _checked_mesh(mesh, device),
                                         n_threads)
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    matrix_d = torch.from_numpy(matrix32).to(device)
    rows_parts, offs_parts = [], []
    n_reads = n_bases = n_matches = 0
    # the launched batch not yet fetched: (positions, n_matches, host
    # words, host ends, n_reads, index of its first read)
    pending = None

    def fetch(batch):
        nonlocal n_matches
        pos_d, nm_d, _words, ends, nr, read_base = batch
        with stage("D2H-matches"):
            hits = int(nm_d)
            if hits > cap:
                raise ValueError(f"batch had {hits} matches > cap {cap}; "
                                 f"raise cap")
            pos = pos_d[:hits].cpu().numpy()
        ends_host = ends[:nr]
        rows = np.searchsorted(ends_host, pos, side="right")
        starts = np.concatenate([[0], ends_host])[rows]
        rows_parts.append(rows + read_base)
        offs_parts.append(pos - starts)
        n_matches += hits

    def launch(parsed):
        nonlocal pending, n_reads, n_bases
        words, ends, nb, nr = parsed
        with stage("H2D", n_bytes=words.nbytes + ends.nbytes,
                   device=on_card):
            words_d = torch.from_numpy(words.view(np.int32)).to(
                device, non_blocking=True)
            ends_d = torch.from_numpy(ends).to(device, non_blocking=True)
        with stage("dispatch", device=on_card):
            scores = pwm_scores_packed(words_d, matrix_d, w)
            pos_d, nm_d = pwm_match_compact(scores, ends_d, nb, threshold,
                                            w, cap)
        # fetch one batch late, so the host never waits on the batch it
        # just launched; a batch keeps its host arrays alive until its
        # fetch, which waits for its work and so for its asynchronous
        # copies
        if pending is not None:
            fetch(pending)
        pending = (pos_d, nm_d, words, ends, nr, n_reads)
        n_reads += nr
        n_bases += nb

    pool = ThreadPoolExecutor(n_threads)
    worker = ThreadPoolExecutor(1)
    try:
        # the worker parses batch i+1 while batch i launches
        parsed = None
        for raw in _prefetched(_batch_arrays(path, target_bases, pool)):
            nxt = worker.submit(carried(_parse_batch), raw)
            if parsed is not None:
                launch(parsed.result())
            parsed = nxt
        if parsed is not None:
            launch(parsed.result())
        if pending is not None:
            fetch(pending)
    finally:
        worker.shutdown(wait=False)
        pool.shutdown(wait=False)

    rows = np.concatenate(rows_parts) if rows_parts \
        else np.empty(0, np.int64)
    offs = np.concatenate(offs_parts) if offs_parts \
        else np.empty(0, np.int64)
    order = np.lexsort((offs, rows))
    stats = {"n_reads": n_reads, "n_bases": n_bases,
             "n_matches": n_matches}
    return rows[order], offs[order], stats


def _motif_matches_fastq_mesh(path: str, matrix32: np.ndarray,
                              threshold: float, cap: int, target_bases: int,
                              mesh: Mesh, n_threads):
    """get_motif_matches_fastq over a mesh: each batch splits on read
    boundaries, every shard scores its reads and compacts its match
    positions on its device (the copy to the host holds the MATCHES),
    and read indices run across the shards in shard order — the
    data-parallel twin of get_motif_scores + threshold (reference:
    bionumpy/sequence/position_weight_matrix.py:85-101,166-196)."""
    w = matrix32.shape[1]
    n_dev = int(mesh.devices.size)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    step = sharded_pwm_match_step(mesh, w, cap)
    matrix_d = torch.from_numpy(matrix32).to(mesh.lead)
    rows_parts, offs_parts = [], []
    n_reads = n_bases = n_matches = 0
    pool = ThreadPoolExecutor(n_threads)
    try:
        for words, ends, n_true, parsed in _sharded_batches(
                path, target_bases, n_dev, pool):
            # the match fetch below waits for the batch's work
            words_d, ends_d = _mesh_batch(mesh, words, ends)
            with stage("mesh-step", device=mesh.lead.type == "cuda"):
                pos, nm, _total = step(words_d, ends_d,
                                       [int(n) for n in n_true], matrix_d,
                                       threshold)
            with stage("D2H-matches"):
                nm_h = torch.stack([t.to(mesh.lead) for t in nm]).cpu()
                hits = [int(h) for h in nm_h]
                pos_h = [p[: min(h, p.numel())].cpu().numpy()
                         for p, h in zip(pos, hits)]
            read_base = n_reads
            for d, (_w, e_host, nb, nr) in enumerate(parsed):
                if hits[d] > cap:
                    raise ValueError(f"shard had {hits[d]} matches > cap "
                                     f"{cap}; raise cap")
                p = pos_h[d]
                ends_host = e_host[:nr]
                r = np.searchsorted(ends_host, p, side="right")
                starts = np.concatenate([[0], ends_host])[r]
                rows_parts.append(r + read_base)
                offs_parts.append(p - starts)
                read_base += nr
                n_matches += hits[d]
                n_bases += nb
            n_reads = read_base
    finally:
        pool.shutdown(wait=False)
    rows = np.concatenate(rows_parts) if rows_parts \
        else np.empty(0, np.int64)
    offs = np.concatenate(offs_parts) if offs_parts \
        else np.empty(0, np.int64)
    order = np.lexsort((offs, rows))
    stats = {"n_reads": n_reads, "n_bases": n_bases,
             "n_matches": n_matches}
    return rows[order], offs[order], stats


@call_span
def count_minimizers_fastq(path: str, k: int = 21, window_size: int = 30,
                           cap: int = 1 << 20,
                           target_bases: int = TARGET_BUCKET - (1 << 21),
                           mesh=None, n_threads: int = None,
                           acc_cap: int = None, device=None):
    """Count the minimizers (the least k-mer hash of each window of
    `window_size` bases, one count per window) of a FASTQ file, plain or
    (multi-member) gzip, on one device: each packed batch's minimizer
    table (kernel 1, the windowed min, sort and compaction,
    ops/minimizers.py) folds into a device accumulator, the batches'
    metas fold on the device, and the host fetches the accumulator's
    live rows once at the end.

    `device`: None is the card ("cuda"), which must be present; pass
    "cpu" to run the plain versions on the host.  `cap` bounds the
    distinct minimizers of one batch's table; a batch that overflows it
    makes the whole job rerun once at a cap that fits.  `acc_cap`
    (default max(4*cap, 2^22)) bounds the job's distinct minimizers
    (AccOverflow).  `mesh=` (a parallel.Mesh) splits each batch on read
    boundaries over the mesh's devices and merges the shards' tables
    into an accumulator on the lead device, one step a batch
    (parallel/sparse_parallel.sharded_minimizer_count_fold_step);
    `device`, when given with a mesh, must be its lead device.

    Returns a SparseEncodedCounts over the DNA k-mer encoding plus a
    stats dict {n_reads, n_bases, n_windows}; equal to the JAX package's
    count_minimizers_fastq on the same file."""
    if not 1 <= k <= MAX_K or k > window_size:
        raise ValueError(f"k must lie in 1..{MAX_K} and be at most "
                         f"window_size={window_size}, got {k}")
    if mesh is not None:
        return _count_minimizers_fastq_mesh(
            path, k, window_size, cap, target_bases,
            _checked_mesh(mesh, device), n_threads, acc_cap)
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    if acc_cap is None:
        acc_cap = max(4 * cap, 1 << 22)
    n_kmers = window_size - k + 1
    acc = _make_acc(acc_cap, device)
    meta_acc = _meta_init(device)
    in_flight = deque()  # (event, host arrays) per batch on the card
    n_reads = n_bases = n_batches = 0

    def launch(parsed):
        nonlocal acc, n_reads, n_bases, n_batches
        words, ends, nb, nr = parsed
        with stage("H2D", n_bytes=words.nbytes + ends.nbytes,
                   device=on_card):
            words_d = torch.from_numpy(words.view(np.int32)).to(
                device, non_blocking=True)
            ends_d = torch.from_numpy(ends).to(device, non_blocking=True)
        with stage("dispatch", device=on_card):
            keys, cnt, meta = minimizer_sentinel_table_packed(
                words_d, ends_d, nb, k, n_kmers, cap)
            _meta_add_packed(meta_acc, meta)
        with stage("device-fold", device=on_card):
            acc = _fold_program_impl(acc, [(keys, cnt)], acc_cap)
        if on_card:
            # the asynchronous copies read the host arrays: keep them
            # until the batch's work is done, _IN_FLIGHT batches at most
            event = torch.cuda.Event()
            event.record()
            in_flight.append((event, words, ends))
            while len(in_flight) > _IN_FLIGHT:
                with stage("backpressure"):
                    in_flight.popleft()[0].synchronize()
        n_reads += nr
        n_bases += nb
        n_batches += 1

    pool = ThreadPoolExecutor(n_threads)
    worker = ThreadPoolExecutor(1)
    try:
        # the worker parses batch i+1 while batch i launches
        parsed = None
        for raw in _prefetched(_batch_arrays(path, target_bases, pool)):
            nxt = worker.submit(carried(_parse_batch), raw)
            if parsed is not None:
                launch(parsed.result())
            parsed = nxt
        if parsed is not None:
            launch(parsed.result())
    finally:
        worker.shutdown(wait=False)
        pool.shutdown(wait=False)

    if n_batches == 0:
        return SparseEncodedCounts(
            KmerEncoding(DNAEncoding, k), np.empty(0, np.uint64),
            np.empty(0, np.int64)), \
            {"n_reads": 0, "n_bases": 0, "n_windows": 0}

    def rerun(max_unique):
        # a batch's table was truncated: redo the job ONCE at a cap that
        # fits (the meta carries every batch's true distinct count)
        new_cap = 1 << (max_unique - 1).bit_length()
        add("cap-rerun", 0.0)
        logger.warning(
            "count_minimizers_fastq: batch table overflow (%d > cap=%d); "
            "rerunning at cap=%d", max_unique, cap, new_cap)
        return count_minimizers_fastq(
            path, k, window_size, cap=new_cap, target_bases=target_bases,
            n_threads=n_threads, device=device,
            acc_cap=max(acc_cap, 4 * new_cap))

    try:
        with stage("D2H-table"):
            hashes, counts, meta_h = _fetch_acc(acc, acc_cap, meta_acc)
    except AccOverflow as e:
        if int(e.meta_h[0]) > cap:
            return rerun(int(e.meta_h[0]))
        raise
    meta = dict(zip(META_FIELDS, (int(v) for v in meta_h)))
    if meta["max_unique"] > cap:
        return rerun(meta["max_unique"])
    stats = {"n_reads": n_reads, "n_bases": n_bases,
             "n_windows": meta["n_kmers"]}
    return SparseEncodedCounts(KmerEncoding(DNAEncoding, k), hashes,
                               counts), stats


def _count_minimizers_fastq_mesh(path: str, k: int, window_size: int,
                                 cap: int, target_bases: int, mesh: Mesh,
                                 n_threads, acc_cap):
    """count_minimizers_fastq over a mesh: the windowed-min table of every
    shard of every batch, merged into an accumulator on the lead device
    in ONE step per batch (the mesh twin of sequence.count_minimizers;
    reference semantics: bionumpy/sequence/minimizers.py:8-54 +
    streams/reductions.py:6-23)."""
    if acc_cap is None:
        acc_cap = max(4 * cap, 1 << 22)
    step = sharded_minimizer_count_fold_step(mesh, k, window_size, cap,
                                             acc_cap)
    table, n_reads, n_bases = _mesh_fold_job(path, step, mesh, target_bases,
                                             n_threads, acc_cap)
    if table is None:
        return SparseEncodedCounts(
            KmerEncoding(DNAEncoding, k), np.empty(0, np.uint64),
            np.empty(0, np.int64)), \
            {"n_reads": 0, "n_bases": 0, "n_windows": 0}
    hashes, counts, meta = table
    if meta["max_unique"] > cap:
        new_cap = 1 << (meta["max_unique"] - 1).bit_length()
        add("cap-rerun", 0.0)
        logger.warning(
            "count_minimizers_fastq(mesh): shard table overflow (%d > "
            "cap=%d); rerunning at cap=%d", meta["max_unique"], cap,
            new_cap)
        return _count_minimizers_fastq_mesh(
            path, k, window_size, new_cap, target_bases, mesh, n_threads,
            max(acc_cap, 4 * new_cap))
    stats = {"n_reads": n_reads, "n_bases": n_bases,
             "n_windows": meta["n_kmers"]}
    return SparseEncodedCounts(KmerEncoding(DNAEncoding, k), hashes,
                               counts), stats


def _rebased_intervals(path: str, chromosome_sizes: dict, bin_size: int):
    """The BED file's intervals on the chromosomes of `chromosome_sizes`,
    mapped to concatenated-genome coordinates (GlobalOffset) and rebased
    so that every chromosome starts on a bin edge.  Returns (starts,
    stops, names, bin_base, n_bins); raises ValueError, as the JAX
    package does, when the rebased span passes int32."""
    with stage("read"):
        data = bnp_open(path).read()
        keep = np.isin(np.asarray(data.chromosome.tolist()),
                       list(chromosome_sizes))
        data = data[keep]
        offset = GlobalOffset(chromosome_sizes)
        g_starts = offset.from_local_coordinates(
            data.chromosome, np.asarray(data.start))
        g_stops = g_starts + (np.asarray(data.stop) - np.asarray(data.start))
    # per-chromosome bin ranges: bins never span chromosomes
    names = list(chromosome_sizes)
    sizes = np.array([chromosome_sizes[n] for n in names], np.int64)
    bins_per = -(-sizes // bin_size)
    bin_base = np.insert(np.cumsum(bins_per), 0, 0)
    n_bins = int(bin_base[-1])
    # remap global positions so every chromosome starts on a bin edge
    chrom_base = np.insert(np.cumsum(sizes), 0, 0)
    chrom_of = np.searchsorted(chrom_base, g_starts, side="right") - 1
    rebased = (g_starts - chrom_base[chrom_of]
               + bin_base[chrom_of] * bin_size)
    rebased_stop = rebased + (g_stops - g_starts)
    # the device arrays are int32: a rebased span past 2^31 (human-scale
    # genomes at small bin_size) would wrap silently
    span = int(bin_base[-1]) * bin_size
    if span > np.iinfo(np.int32).max:
        raise ValueError(
            f"binned_pileup_bed: rebased genome span {span} exceeds "
            f"int32; raise bin_size or split the call per chromosome "
            f"(each chromosome's own span stays within int32)")
    return rebased, rebased_stop, names, bin_base, n_bins


@call_span
def binned_pileup_bed(path: str, chromosome_sizes: dict,
                      bin_size: int = 1000, mesh=None, device=None):
    """Whole-genome BINNED coverage track from a BED(.gz) file on one
    device: the intervals on the chromosomes of `chromosome_sizes` map to
    concatenated-genome coordinates (GlobalOffset), rebased so that every
    chromosome starts on a bin edge, and one binned_pileup
    (ops/tracks.py) over all of them gives the covered-base count per bin;
    the host fetches the bins once.

    `device`: None is the card ("cuda"), which must be present; pass
    "cpu" to run the plain torch ops on the host.  `mesh=` (a
    parallel.Mesh) splits the intervals row-wise over the mesh's devices,
    each computes its partial bins and one psum on the lead device merges
    them (parallel/reductions.sharded_binned_pileup_step); `device`, when
    given with a mesh, must be its lead device.  Raises ValueError, as
    the JAX package does, when the rebased span (bins x bin_size) passes
    int32: then no bin_size helps (the span is at least the genome's
    size), and the call must be split per chromosome.

    Returns ({chromosome: int32 per-bin covered-base counts},
    stats {n_intervals, n_bins}); equal to the JAX package's
    binned_pileup_bed on the same file."""
    if mesh is not None:
        mesh = _checked_mesh(mesh, device)
    else:
        device = resolve_device(device)
    rebased, rebased_stop, names, bin_base, n_bins = _rebased_intervals(
        path, chromosome_sizes, bin_size)
    n_iv = len(rebased)
    if mesh is None:
        with stage("H2D", n_bytes=8 * n_iv, device=device.type == "cuda"):
            starts = torch.from_numpy(rebased.astype(np.int32)).to(device)
            stops = torch.from_numpy(rebased_stop.astype(np.int32)).to(device)
            valid = torch.ones(n_iv, dtype=torch.bool, device=device)
        with stage("step"):
            bins = binned_pileup(starts, stops, valid, n_bins, bin_size)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    else:
        n_dev = int(mesh.devices.size)
        per = max(-(-n_iv // n_dev), 1)
        starts = np.zeros((n_dev, per), np.int32)
        stops = np.zeros((n_dev, per), np.int32)
        valid = np.zeros((n_dev, per), bool)
        for d in range(n_dev):
            part = slice(d * per, (d + 1) * per)
            m = len(rebased[part])
            starts[d, :m] = rebased[part]
            stops[d, :m] = rebased_stop[part]
            valid[d, :m] = True
        with stage("H2D", n_bytes=starts.nbytes + stops.nbytes
                   + valid.nbytes, device=mesh.lead.type == "cuda"):
            shards = [put_sharded(mesh, a) for a in (starts, stops, valid)]
        with stage("mesh-step", device=mesh.lead.type == "cuda"):
            bins = sharded_binned_pileup_step(mesh, n_bins, bin_size)(
                *shards)
            if mesh.lead.type == "cuda":
                torch.cuda.synchronize(mesh.lead)
    with stage("D2H-table", n_bytes=4 * n_bins):
        bins_h = bins.cpu().numpy()
    out = {name: bins_h[bin_base[i]: bin_base[i + 1]]
           for i, name in enumerate(names)}
    stats = {"n_intervals": n_iv, "n_bins": n_bins}
    return out, stats


def merge_sorted_tables(h1, c1, h2, c2):
    """Merge two SORTED (hash, count) tables, summing equal keys — O(n)
    numpy passes (an argsort of the concatenation costs ~3x more; this
    is the associative fold of the reference's stream reductions,
    bionumpy/streams/reductions.py:6-23)."""
    if len(h1) == 0:
        return h2, c2
    if len(h2) == 0:
        return h1, c1
    pos2 = np.searchsorted(h1, h2, side="right") + \
        np.arange(len(h2), dtype=np.int64)
    n = len(h1) + len(h2)
    out_h = np.empty(n, h1.dtype)
    out_c = np.empty(n, np.int64)
    mask1 = np.ones(n, bool)
    mask1[pos2] = False
    out_h[pos2] = h2
    out_c[pos2] = c2
    out_h[mask1] = h1
    out_c[mask1] = c1
    keep = np.empty(n, bool)
    keep[0] = True
    np.not_equal(out_h[1:], out_h[:-1], out=keep[1:])
    idx = np.flatnonzero(keep)
    return out_h[idx], np.add.reduceat(out_c, idx)
