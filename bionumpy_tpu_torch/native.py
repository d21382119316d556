"""ctypes bindings for the port's native host kernels
(csrc/host/host_kernels.cpp and csrc/host/inflate.cpp): the port's own
copy of bionumpy_tpu/native.py.

Built on demand with g++ into the package's `_build/` directory.  This is
host code, not a device kernel.  The gzip-FASTQ helpers keep a pure-numpy
fallback, so those paths work without a C++ compiler.  The file readers'
helpers (find_positions, parse_ints, bam_find_starts, gather_rows) raise
when the library did not build; each has a numpy twin (`_..._py`) that
the tests hold it to."""
from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

from .ops import _build

logger = logging.getLogger(__name__)

_SRC_PATHS = [os.path.join(_build.CSRC, "host", "host_kernels.cpp"),
              os.path.join(_build.CSRC, "host", "inflate.cpp")]
_lib = None
_tried = False
_error = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _load():
    """The host library, built if needed; None without a compiler."""
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    try:
        path = _build.build("host_kernels", _SRC_PATHS,
                            ["g++"] + _build.HOST_FLAGS)
    except (OSError, RuntimeError) as e:
        logger.info("could not build native host kernels: %s", e)
        _error = e
        return None
    lib = ctypes.CDLL(path)
    lib.pack_2bit.restype = None
    lib.pack_2bit.argtypes = [_U8P, ctypes.c_long, _U8P]
    lib.pack_2bit_fill.restype = None
    lib.pack_2bit_fill.argtypes = [_U8P, ctypes.c_long, _U8P,
                                   ctypes.c_long, ctypes.c_int]
    lib.kmer_correction_sums.restype = None
    lib.kmer_correction_sums.argtypes = [
        _U8P, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32)]
    lib.fastq_parse_pack.restype = ctypes.c_long
    lib.fastq_parse_pack.argtypes = [
        _U8P, ctypes.c_long, _U8P, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
    lib.gzip_inflate_all.restype = ctypes.c_long
    lib.gzip_inflate_all.argtypes = [_U8P, ctypes.c_long, _U8P,
                                     ctypes.c_long, ctypes.c_int]
    lib.gzip_inflate_count.restype = ctypes.c_long
    lib.gzip_inflate_count.argtypes = [
        _U8P, ctypes.c_long, _U8P, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_long)]
    lib.count_byte.restype = ctypes.c_long
    lib.count_byte.argtypes = [_U8P, ctypes.c_long, ctypes.c_uint8,
                               ctypes.c_int]
    lib.copy_2bit_shifted.restype = None
    lib.copy_2bit_shifted.argtypes = [_U8P, ctypes.c_long, _U8P,
                                      ctypes.c_long]
    lib.count_two_bytes.restype = ctypes.c_long
    lib.count_two_bytes.argtypes = [_U8P, ctypes.c_long, ctypes.c_uint8,
                                    ctypes.c_uint8]
    lib.find_two_bytes.restype = ctypes.c_long
    lib.find_two_bytes.argtypes = [_U8P, ctypes.c_long, ctypes.c_uint8,
                                   ctypes.c_uint8, _I64P]
    lib.bam_find_starts.restype = ctypes.c_long
    lib.bam_find_starts.argtypes = [_U8P, ctypes.c_long, _I64P,
                                    ctypes.c_long]
    lib.gather_rows_u8.restype = ctypes.c_long
    lib.gather_rows_u8.argtypes = [_U8P, ctypes.c_long, _I64P, _I64P,
                                   ctypes.c_long, _U8P]
    lib.parse_ints.restype = ctypes.c_long
    lib.parse_ints.argtypes = [_U8P, ctypes.c_long, _I64P, _I64P,
                               ctypes.c_long, _I64P]
    _lib = lib
    return _lib


def has_native() -> bool:
    """True when the host library built and loaded."""
    return _load() is not None


def _require():
    """The host library; raises when it did not build (the readers'
    helpers take no silent numpy path)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native host library did not build: "
                           f"{_error}")
    return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _i64(arr: np.ndarray):
    return arr.ctypes.data_as(_I64P)


def pack_2bit_fill(codes: np.ndarray, out_bytes: int,
                   n_threads: int = None) -> np.ndarray:
    """Pack len(codes) 2-bit codes into an `out_bytes`-byte buffer,
    zero-filling past the packed prefix — no pre-padded copy of the
    codes is made (multithreaded)."""
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if out_bytes * 4 < len(codes):
        raise ValueError(f"{len(codes)} codes do not fit {out_bytes} bytes")
    if lib is None:
        n4 = (len(codes) + 3) // 4 * 4
        padded = np.zeros(n4, dtype=np.uint8)
        padded[: len(codes)] = codes
        out = np.zeros(out_bytes, dtype=np.uint8)
        out[: n4 // 4] = pack_2bit(padded)
        return out
    if n_threads is None:
        n_threads = min(4, os.cpu_count() or 1)
    out = np.empty(out_bytes, dtype=np.uint8)
    lib.pack_2bit_fill(_ptr(codes), len(codes), _ptr(out), out_bytes,
                       n_threads)
    return out


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """4 codes/byte little-endian pack; len(codes) must be a multiple
    of 4."""
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if len(codes) % 4:
        raise ValueError("pack_2bit needs a multiple of 4 codes")
    if lib is None:
        return (codes[0::4] | (codes[1::4] << 2) | (codes[2::4] << 4)
                | (codes[3::4] << 6))
    out = np.empty(len(codes) // 4, dtype=np.uint8)
    lib.pack_2bit(_ptr(codes), len(codes), _ptr(out))
    return out


def kmer_correction_sums(packed: np.ndarray, ends: np.ndarray,
                         starts: np.ndarray, k: int,
                         n_threads: int = None) -> tuple:
    """(lo_sum, hi_sum) mod 2^32 of the limbs of every row-crossing
    window (the up-to-(k-1) windows before each row end), recomputed
    from the 2-bit-packed byte buffer.  Subtracting these from the
    device's unmasked full sums yields the valid-window checksum; runs
    on host threads, overlapped with the device pass."""
    lib = _load()
    packed = np.ascontiguousarray(packed.view(np.uint8).ravel())
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    if len(ends) != len(starts):
        raise ValueError("ends and starts differ in length")
    if lib is None:
        return _kmer_correction_sums_py(packed, ends, starts, k)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    out = np.zeros(2, dtype=np.uint32)
    lib.kmer_correction_sums(
        _ptr(packed), len(packed),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ends), k, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return int(out[0]), int(out[1])


def _kmer_correction_sums_py(packed: np.ndarray, ends: np.ndarray,
                             starts: np.ndarray, k: int) -> tuple:
    """Vectorized numpy twin of the native correction kernel."""
    if len(ends) == 0 or k <= 1:
        return 0, 0
    offs = np.arange(k - 1, 0, -1, dtype=np.int64)
    pos = ends[:, None] - offs[None, :]                     # (R, k-1)
    mask = pos >= starts[:, None]
    pos = np.maximum(pos, 0)
    # gather 2x uint64 straddling each window start (unaligned loads via
    # per-byte gathers on a zero-extended buffer)
    byte = (pos >> 2).ravel()
    sh = ((pos & 3) * 2).astype(np.uint64).ravel()
    buf = np.zeros(len(packed) + 16, dtype=np.uint8)
    buf[: len(packed)] = packed
    idx = byte[:, None] + np.arange(16, dtype=np.int64)
    b = buf[idx].astype(np.uint64)
    shifts8 = np.uint64(8) * np.arange(8, dtype=np.uint64)
    w0 = (b[:, :8] << shifts8).sum(axis=-1, dtype=np.uint64)
    w1 = (b[:, 8:] << shifts8).sum(axis=-1, dtype=np.uint64)
    val = (w0 >> sh) | np.where(sh == 0, np.uint64(0),
                                w1 << (np.uint64(64) - sh))
    if 2 * k < 64:
        val &= np.uint64((1 << (2 * k)) - 1)
    val = np.where(mask.ravel(), val, np.uint64(0))
    lo = int(np.sum(val & np.uint64(0xFFFFFFFF),
                    dtype=np.uint64) & np.uint64(0xFFFFFFFF))
    hi = int(np.sum(val >> np.uint64(32),
                    dtype=np.uint64) & np.uint64(0xFFFFFFFF))
    return lo, hi


def fastq_parse_pack(raw: np.ndarray, out_bytes: int = None,
                     n_threads: int = None):
    """Fused FASTQ chunk parse: raw bytes (ending on an entry boundary)
    -> (packed 2-bit words as uint8 of size out_bytes, int32 sequence
    lengths, n_bases).  One multithreaded native pass.

    Raises ValueError with the byte offset of the first malformed or
    unencodable byte."""
    lib = _load()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n = len(raw)
    if out_bytes is None:
        out_bytes = n // 4 + 16
    if lib is None:
        return _fastq_parse_pack_py(raw, out_bytes)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    max_entries = n // 5 + 2   # an entry is at least '@\nA\n+\nB\n'
    lengths = np.empty(max_entries, dtype=np.int32)
    out = np.empty(out_bytes, dtype=np.uint8)
    n_bases = np.zeros(1, dtype=np.int64)
    res = lib.fastq_parse_pack(
        _ptr(raw), n, _ptr(out), out_bytes,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_entries, n_threads,
        n_bases.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if res < 0:
        raise ValueError(f"malformed FASTQ chunk at byte {-res - 1}")
    return out, lengths[:res].copy(), int(n_bases[0])


def _fastq_parse_pack_py(raw: np.ndarray, out_bytes: int):
    """Numpy twin of the native fused FASTQ parse."""
    nl = np.flatnonzero(raw == 10)
    if len(nl) % 4 != 0:
        raise ValueError(f"malformed FASTQ chunk at byte {len(raw)}")
    n_entries = len(nl) // 4
    if n_entries == 0:
        return np.zeros(out_bytes, np.uint8), np.empty(0, np.int32), 0
    starts = np.insert(nl[:-1] + 1, 0, 0)
    h_starts = starts[0::4]
    p_starts = starts[2::4]
    if not (np.all(raw[h_starts] == ord("@")) and
            np.all(raw[p_starts] == ord("+"))):
        bad = np.flatnonzero(raw[h_starts] != ord("@"))
        pos = h_starts[bad[0]] if len(bad) else \
            p_starts[np.flatnonzero(raw[p_starts] != ord("+"))[0]]
        raise ValueError(f"malformed FASTQ chunk at byte {pos}")
    s_starts = starts[1::4]
    s_lens = nl[1::4] - s_starts
    q_lens = nl[3::4] - starts[3::4]
    if not np.all(q_lens == s_lens):
        pos = starts[3::4][np.flatnonzero(q_lens != s_lens)[0]]
        raise ValueError(f"malformed FASTQ chunk at byte {pos}")
    enc = np.full(256, 255, np.uint8)
    for i, cs in enumerate("ACGT"):
        enc[ord(cs)] = i
        enc[ord(cs.lower())] = i
    idx = np.repeat(s_starts - np.insert(np.cumsum(s_lens)[:-1], 0, 0),
                    s_lens) + np.arange(int(s_lens.sum()), dtype=np.int64)
    codes = enc[raw[idx]]
    bad = np.flatnonzero(codes == 255)
    if len(bad):
        raise ValueError(f"malformed FASTQ chunk at byte {idx[bad[0]]}")
    n_bases = len(codes)
    out = pack_2bit_fill(codes, out_bytes)
    return out, s_lens.astype(np.int32), n_bases


def gzip_inflate(data, verify: bool = True, size_hint: int = None):
    """Inflate a whole (possibly multi-member) gzip byte string with the
    native libdeflate-style decoder.  Returns bytes, or None when the
    native library is missing (callers fall back to zlib).  Raises
    zlib-compatible errors on malformed input so io/pgzip.py's boundary
    repair keeps working."""
    import zlib
    lib = _load()
    if lib is None:
        return None
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    n = len(data)
    if n == 0:
        return b""
    cap = size_hint if size_hint else max(4 * n + 1024, 1 << 16)
    src = np.frombuffer(data, np.uint8)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        res = lib.gzip_inflate_all(_ptr(src), n, _ptr(out), cap,
                                   1 if verify else 0)
        if res >= 0:
            return out[:res].tobytes()
        if res == -2:
            cap *= 2
            continue
        if res == -3:
            raise zlib.error("native inflate: CRC/length mismatch")
        raise zlib.error("native inflate: malformed gzip stream")


def count_byte(buf: np.ndarray, value: int, n_threads: int = None) -> int:
    """Occurrences of `value` in a contiguous uint8 buffer at memchr
    speed (bytes.count for ndarrays without the tobytes copy)."""
    lib = _load()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if lib is None:
        return int(np.count_nonzero(buf == value))
    if n_threads is None:
        n_threads = min(4, os.cpu_count() or 1)
    return int(lib.count_byte(_ptr(buf), len(buf), value, n_threads))


def _member_ptrs(data, start: int, out: np.ndarray, out_off: int):
    base = np.frombuffer(data, np.uint8).ctypes.data  # zero-copy view
    src = ctypes.cast(ctypes.c_void_p(base + start), _U8P)
    dst = ctypes.cast(ctypes.c_void_p(out.ctypes.data + out_off), _U8P)
    return src, dst


def gzip_inflate_into(data, start: int, end: int,
                      out: np.ndarray, out_off: int, expect: int) -> bool:
    """Inflate the gzip member in data[start:end] DIRECTLY into
    out[out_off : out_off + expect] (no intermediate bytes object).

    Returns True iff inflation succeeded, produced exactly `expect`
    bytes, and the CRC verified; False on any mismatch or when the
    native library is missing (callers fall back to a copying path).
    Safe to call concurrently for disjoint output ranges."""
    lib = _load()
    if lib is None:
        return False
    src, dst = _member_ptrs(data, start, out, out_off)
    return lib.gzip_inflate_all(src, end - start, dst, expect, 1) == expect


def gzip_inflate_count_into(data, start: int, end: int, out: np.ndarray,
                            out_off: int, expect: int,
                            value: int = 10) -> int:
    """gzip_inflate_into with a FUSED byte-value count: occurrences of
    `value` in the inflated output are tallied during the CRC-verify
    pass (one memory pass instead of two).  Returns the count, or -1 on
    any mismatch / missing library."""
    lib = _load()
    if lib is None:
        return -1
    src, dst = _member_ptrs(data, start, out, out_off)
    cnt = ctypes.c_long(0)
    res = lib.gzip_inflate_count(src, end - start, dst, expect, value,
                                 ctypes.byref(cnt))
    return int(cnt.value) if res == expect else -1


def copy_2bit_shifted(src: np.ndarray, n_bases: int, dst: np.ndarray,
                      dst_base_off: int) -> bool:
    """Append a 2-bit-packed stream (src, from base 0) into dst at base
    offset dst_base_off.  Streams must append left-to-right (bytes past
    the first touched byte are overwritten).  False when the native
    library is missing."""
    lib = _load()
    if lib is None:
        return False
    lib.copy_2bit_shifted(_ptr(src), int(n_bases), _ptr(dst),
                          int(dst_base_off))
    return True


def find_positions(buf: np.ndarray, value_a: int,
                   value_b: int = None) -> np.ndarray:
    """Positions of bytes equal to value_a (or value_b) in a uint8
    buffer, as int64, in one SIMD pass: np.flatnonzero((buf == a) |
    (buf == b)) without numpy's three passes."""
    lib = _require()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if value_b is None:
        value_b = value_a
    n = lib.count_two_bytes(_ptr(buf), len(buf), value_a, value_b)
    out = np.empty(n, dtype=np.int64)
    lib.find_two_bytes(_ptr(buf), len(buf), value_a, value_b, _i64(out))
    return out


def _find_positions_py(buf: np.ndarray, value_a: int,
                       value_b: int = None) -> np.ndarray:
    """Numpy twin of find_positions."""
    buf = np.asarray(buf, dtype=np.uint8)
    if value_b is None:
        value_b = value_a
    return np.flatnonzero((buf == value_a) | (buf == value_b)).astype(
        np.int64)


def bam_find_starts(chunk: np.ndarray) -> np.ndarray:
    """All BAM record start offsets <= len(chunk), starting at 0:
    start' = start + 4 + block_len(start), followed until the next start
    would pass the chunk's end."""
    lib = _require()
    chunk = np.ascontiguousarray(chunk, dtype=np.uint8)
    max_starts = len(chunk) // 4 + 2
    starts = np.empty(max_starts, dtype=np.int64)
    count = lib.bam_find_starts(_ptr(chunk), len(chunk), _i64(starts),
                                max_starts)
    if count < 0:
        raise ValueError("corrupt BAM block length")
    return starts[:count]


def _bam_find_starts_py(chunk: np.ndarray) -> np.ndarray:
    """Numpy twin of bam_find_starts."""
    chunk = np.asarray(chunk, dtype=np.uint8)
    n = len(chunk)
    starts = [0]
    pos = 0
    while pos + 4 <= n:
        nxt = pos + 4 + int.from_bytes(chunk[pos: pos + 4].tobytes(),
                                       "little")
        if nxt > n:
            break
        starts.append(nxt)
        pos = nxt
    return np.array(starts, dtype=np.int64)


def _gather_plan_ok(src_n: int, starts: np.ndarray,
                    lens: np.ndarray) -> bool:
    return not len(lens) or (lens.min() >= 0 and starts.min() >= 0
                             and int((starts + lens).max()) <= src_n)


def gather_rows(src: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Packed gather of the byte rows [starts[r], starts[r] + lens[r])
    of a uint8 buffer in one memcpy pass, where numpy's index plan takes
    six int64 passes.  The hot path of delimited-format column
    extraction.  Returns the flat uint8 result, or None when a row is out
    of bounds or of negative length (the caller then takes the checked
    numpy plan)."""
    lib = _require()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    # a malformed plan must not size the output: a negative length after
    # valid rows would overflow an output sized by the smaller sum
    if not _gather_plan_ok(len(src), starts, lens):
        return None
    total = int(lens.sum())
    out = np.empty(total + 8, dtype=np.uint8)  # 7 bytes of slack
    got = lib.gather_rows_u8(_ptr(src), len(src), _i64(starts), _i64(lens),
                             len(starts), _ptr(out))
    return out[:total] if got == total else None


def _gather_rows_py(src: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Numpy twin of gather_rows."""
    src = np.asarray(src, dtype=np.uint8)
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    if not _gather_plan_ok(len(src), starts, lens):
        return None
    offsets = np.repeat(starts - np.cumsum(lens) + lens, lens)
    return src[offsets + np.arange(int(lens.sum()), dtype=np.int64)]


def parse_ints(src: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Signed decimal rows [starts[r], ends[r]) of a uint8 buffer as
    int64, in one pass with no padded digit matrix.  Returns None when a
    row is empty, holds a non-digit after its sign, has more than 18
    digits or lies out of bounds: the caller then takes the checked numpy
    path, which raises the FormatException with its offsets."""
    lib = _require()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    out = np.empty(len(starts), dtype=np.int64)
    status = lib.parse_ints(_ptr(src), len(src), _i64(starts), _i64(ends),
                            len(starts), _i64(out))
    return out if status == 0 else None


def _parse_ints_py(src: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Numpy twin of parse_ints (the same rows give None)."""
    src = np.asarray(src, dtype=np.uint8)
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    if not len(starts):
        return np.empty(0, dtype=np.int64)
    if starts.min() < 0 or ends.max() > len(src) or np.any(ends <= starts):
        return None
    first = src[starts]
    neg = first == ord("-")
    digits_start = starts + (neg | (first == ord("+")))
    n_digits = ends - digits_start
    if np.any(n_digits <= 0) or np.any(n_digits > 18):
        return None
    width = int(n_digits.max())
    # right-aligned (rows, width) digit matrix, zero-padded on the left
    idx = ends[:, None] - width + np.arange(width, dtype=np.int64)
    inside = idx >= digits_start[:, None]
    codes = src[np.where(inside, idx, 0)].astype(np.int64) - ord("0")
    if np.any(inside & ((codes < 0) | (codes > 9))):
        return None
    codes = np.where(inside, codes, 0)
    values = codes @ (10 ** np.arange(width - 1, -1, -1, dtype=np.int64))
    return np.where(neg, -values, values)
