"""BAM binary alignment parsing (reference: bionumpy/io/bam.py).

Record framing reads block lengths from a precomputed little-endian int
view (one numpy pass) and walks starts with O(1) work per record —
avoiding the reference's per-record ``bytes``/``int.from_bytes``
allocation loop (bionumpy/io/bam.py:296-313).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, List, Tuple, Union

import numpy as np

from ..alignments.cigar import count_reference_length, split_cigar
from ..datatypes import BamEntry, Bed6
from ..encoded_array import BaseEncoding, EncodedArray, EncodedRaggedArray
from ..encodings.alphabet_encoding import BamEncoding
from ..ragged import RaggedArray, RaggedShape, RaggedView, ragged_slice
from ..util import cached_property
from .file_buffers import FileBuffer


def find_bam_record_starts(chunk: np.ndarray) -> np.ndarray:
    """All record start offsets <= len(chunk), following the recurrence
    start' = start + 4 + block_len(start), by the native C++ scanner
    (csrc/host/host_kernels.cpp)."""
    from ..native import bam_find_starts
    return bam_find_starts(np.asarray(chunk))


class BamBufferExtractor:
    """Field extraction from framed BAM records (reference:
    bionumpy/io/bam.py:18-167)."""

    def __init__(self, data: np.ndarray, starts: np.ndarray,
                 ends: np.ndarray, header_data: Any,
                 is_contiguous: bool = True):
        self._data = np.asarray(data)
        self._starts = starts
        self._ends = ends
        self._chromosome_names = np.array([h[0] for h in header_data])
        self._header_data = header_data
        self._is_contiguous = is_contiguous
        self._functions = [self._get_chromosome, self._get_read_name,
                           self._get_flag, self._get_position,
                           self._get_mapq, self._get_cigar_symbol,
                           self._get_cigar_length, self._get_sequences,
                           self._get_quality]

    def __len__(self):
        return len(self._starts)

    def __getitem__(self, item):
        return self.__class__(self._data, self._starts[item],
                              self._ends[item], self._header_data,
                              is_contiguous=False)

    def _make_contiguous(self):
        lens = self._ends - self._starts
        new_starts = np.insert(np.cumsum(lens), 0, 0)
        self._data = self._data[RaggedView(self._starts,
                                           lens).get_flat_indices()]
        self._starts = new_starts[:-1]
        self._ends = new_starts[1:]
        self._is_contiguous = True

    @property
    def data(self) -> np.ndarray:
        if not self._is_contiguous:
            self._make_contiguous()
        return self._data

    @property
    def size(self) -> int:
        if self._is_contiguous:
            return self._data.size
        return int((self._ends - self._starts).sum())

    def _get_ints(self, offset, n_bytes, dtype):
        window = self._data[(self._starts + offset)[:, None] +
                            np.arange(n_bytes)]
        return np.ascontiguousarray(window).view(dtype).ravel()

    @cached_property
    def _layout(self):
        """Per-record variable-section boundaries, all derived in one
        pass from the fixed 36-byte prefix: (read_name_start,
        cigar_start, sequence_start, quality_start, l_seq).  The BAM
        record layout is name\\0 | cigar u32s | 4-bit seq | qual."""
        name_len = self._data[self._starts + 12].astype(np.int64)
        cigar_bytes = 4 * self._get_ints(16, 2, np.uint16).astype(np.int64)
        l_seq = self._get_ints(20, 4, np.int32).astype(np.int64)
        name_start = self._starts + 36
        cigar_start = name_start + name_len
        seq_start = cigar_start + cigar_bytes
        qual_start = seq_start + (l_seq + 1) // 2
        return name_start, cigar_start, seq_start, qual_start, l_seq

    @property
    def _read_name_start(self):
        return self._layout[0]

    @property
    def _cigar_start(self):
        return self._layout[1]

    @property
    def _sequence_start(self):
        return self._layout[2]

    @property
    def _quality_start(self):
        return self._layout[3]

    @property
    def _sequence_length(self):
        return self._layout[4]

    def _get_chromosome(self):
        ref_id = self._get_ints(4, 4, np.int32)
        return self._chromosome_names[ref_id]

    def _get_read_name(self):
        read_names = ragged_slice_flat(self._data, self._read_name_start,
                                       self._cigar_start - 1)
        return EncodedRaggedArray(
            EncodedArray(read_names.ravel(), BaseEncoding),
            RaggedShape(read_names.lengths))

    def _get_flag(self):
        return self._get_ints(18, 2, np.uint16)

    def _get_position(self):
        return self._get_ints(8, 4, np.int32)

    def _get_mapq(self):
        return self._data[self._starts + 13]

    def _get_cigar(self):
        cigars = ragged_slice_flat(self._data, self._cigar_start,
                                   self._sequence_start)
        words = RaggedArray(
            np.ascontiguousarray(cigars.ravel()).view(np.uint32),
            cigars.lengths // 4)
        return split_cigar(words)

    def _get_cigar_symbol(self):
        return self._get_cigar()[0]

    def _get_cigar_length(self):
        return self._get_cigar()[1]

    def _get_sequences(self):
        l_seq = self._sequence_length
        n_seq_bytes = (l_seq + 1) // 2
        packed = ragged_slice_flat(self._data, self._sequence_start,
                                   self._quality_start)
        # unpack two 4-bit codes per byte (high nibble first)
        flat = packed.ravel()
        codes = ((flat[:, None] >> (4 * np.arange(2, dtype=np.uint8)[::-1]))
                 .ravel() & np.uint8(15))
        unpacked = EncodedRaggedArray(EncodedArray(codes, BamEncoding),
                                      n_seq_bytes * 2)
        return _trim_ragged(unpacked, l_seq)

    def _get_quality(self):
        return ragged_slice_flat(self._data, self._quality_start,
                                 self._quality_start + self._sequence_length)

    def get_field_by_number(self, i: int):
        return self._functions[i]()


def ragged_slice_flat(data: np.ndarray, starts, ends) -> RaggedArray:
    lens = ends - starts
    view = RaggedView(starts, lens)
    return RaggedArray(data[view.get_flat_indices()], view.get_shape())


def _trim_ragged(ragged, new_lens):
    view = RaggedView(ragged.starts, new_lens)
    flat = ragged.ravel()
    if isinstance(flat, EncodedArray):
        return EncodedRaggedArray(
            EncodedArray(flat.raw()[view.get_flat_indices()], flat.encoding),
            view.get_shape())
    return RaggedArray(flat[view.get_flat_indices()], view.get_shape())


class BamHeader:
    """BAM header: magic + refs (reference: bionumpy/io/bam.py:169-231)."""

    def __init__(self, file_object):
        self._file_object = file_object
        self._header_data = []
        self.info = self.read_header()

    def read(self, n_bytes: int) -> bytes:
        data = self._file_object.read(n_bytes)
        self._header_data.append(data)
        return data

    def _read_zero_term(self) -> str:
        chars = []
        while True:
            chars.append(self.read(1))
            if chars[-1] == b"\x00":
                break
        return "".join(c.decode("ascii") for c in chars[:-1])

    def _read_int(self) -> int:
        return int.from_bytes(self.read(4), byteorder="little")

    def read_header(self) -> List[Tuple[str, int]]:
        magic = self.read(4)
        assert magic == b"BAM\1", magic
        header_length = self._read_int()
        self.read(header_length)
        n_ref = self._read_int()
        return [self._read_ref() for _ in range(n_ref)]

    def _read_ref(self) -> Tuple[str, int]:
        self._read_int()  # name length (zero-terminated read follows)
        name = self._read_zero_term()
        sequence_length = self._read_int()
        return (name, sequence_length)

    def bytes(self) -> bytes:
        return b"".join(self._header_data)


class BamBuffer(FileBuffer):
    supports_modified_write = False
    dataclass = BamEntry

    def __init__(self, buffer_extractor, header_data=None):
        self._is_validated = True
        self._header_data = header_data
        self._buffer_extractor = buffer_extractor

    def __getitem__(self, idx):
        sliced = self._buffer_extractor[idx]
        return self.__class__(sliced, self._header_data)

    def get_field_range_as_text(self, *args):
        raise NotImplementedError("cannot write BAM with modified values")

    n_lines = property(lambda self: len(self._buffer_extractor))
    size = property(lambda self: self._buffer_extractor.size)
    data = property(lambda self: self._buffer_extractor.data)

    @classmethod
    def read_header(cls, file_object) -> BamHeader:
        return BamHeader(file_object)

    @classmethod
    def make_header(cls, data) -> bytes:
        return data.get_context("header").bytes()

    @classmethod
    def contains_complete_entry(cls, chunks) -> bool:
        return True

    @classmethod
    def from_raw_buffer(cls, chunk, header_data: BamHeader) -> "BamBuffer":
        chunk = np.asarray(chunk)
        starts = find_bam_record_starts(chunk)
        extractor = BamBufferExtractor(chunk[: starts[-1]], starts[:-1],
                                       starts[1:], header_data.info)
        return cls(extractor, header_data)

    def get_data(self) -> BamEntry:
        return BamEntry(*(self.get_field_by_number(i) for i in range(9)))

    def get_field_by_number(self, i, dtype=None):
        return self._buffer_extractor.get_field_by_number(i)

    def count_entries(self) -> int:
        return len(self._buffer_extractor)


class BamIntervalBuffer(BamBuffer):
    """BAM -> Bed6 intervals via cigar reference length (reference:
    bionumpy/io/bam.py:334-366)."""
    dataclass = Bed6

    def get_field_by_number(self, i, dtype=None):
        ex = self._buffer_extractor
        funcs = [
            lambda: ex.get_field_by_number(0),
            lambda: ex.get_field_by_number(3),
            lambda: ex.get_field_by_number(3) + count_reference_length(
                *(ex.get_field_by_number(j) for j in (5, 6))),
            lambda: ex.get_field_by_number(1),
            lambda: ex.get_field_by_number(4),
            lambda: EncodedArray(
                np.where(np.asarray(ex.get_field_by_number(2)) &
                         np.uint16(16), ord("-"), ord("+"))[:, None]
                .astype(np.uint8),
                BaseEncoding),
        ]
        return funcs[i]()

    def get_data(self):
        return self.dataclass(*(self.get_field_by_number(i)
                                for i in range(6)))
