"""n-lines-per-entry text formats: 2-line FASTA, FASTQ base
(reference: bionumpy/io/one_line_buffer.py:14-193)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from ..bnpdataclass import BNPDataClass
from ..datatypes import SequenceEntry
from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray)
from .dump_csv import get_column
from .exceptions import FormatException
from .file_buffers import (FileBuffer, IncompleteEntryException, NEWLINE,
                           TextThroughputExtractor)


class OneLineBuffer(FileBuffer):
    n_lines_per_entry = 2
    _buffer_divisor = 32
    _line_offsets = (1, 0)
    _empty_lines = []

    def __init__(self, buffer_extractor: TextThroughputExtractor):
        self._buffer_extractor = buffer_extractor
        self._is_validated = True

    @property
    def n_lines(self) -> int:
        return len(self._buffer_extractor) * self.n_lines_per_entry

    @property
    def data(self) -> EncodedArray:
        return self._buffer_extractor.data

    @classmethod
    def contains_complete_entry(cls, chunks) -> Union[bool, Tuple]:
        if len(chunks) == 1:
            try:
                return True, cls.from_raw_buffer(chunks[0])
            except IncompleteEntryException:
                return False
        return super().contains_complete_entry(chunks)

    @classmethod
    def from_raw_buffer(cls, chunk, header_data=None) -> "OneLineBuffer":
        assert header_data is None
        chunk = EncodedArray(chunk, BaseEncoding)
        from ..native import find_positions
        new_lines = find_positions(chunk.raw(), ord(NEWLINE))
        n_lines = new_lines.size
        if n_lines < cls.n_lines_per_entry:
            raise IncompleteEntryException(
                "No complete entry in buffer. Try increasing chunk_size.")
        new_lines = new_lines[: n_lines - (n_lines % cls.n_lines_per_entry)]
        data = chunk[: new_lines[-1] + 1]
        cls._validate(data, new_lines)
        return cls(cls._get_buffer_extractor(data, new_lines))

    @classmethod
    def _get_buffer_extractor(cls, data, new_lines) -> TextThroughputExtractor:
        line_starts = np.insert(new_lines, 0, -1) + 1
        field_ends = new_lines.reshape(-1, cls.n_lines_per_entry)
        field_ends = cls._modify_for_carriage_return(field_ends, data)
        field_starts = line_starts[:-1].reshape(-1, cls.n_lines_per_entry) + \
            np.array(cls._line_offsets)
        entry_starts = line_starts[:-1: cls.n_lines_per_entry]
        entry_ends = line_starts[:: cls.n_lines_per_entry][1:]
        return TextThroughputExtractor(data, field_starts,
                                       field_ends=field_ends,
                                       entry_starts=entry_starts,
                                       entry_ends=entry_ends)

    @classmethod
    def _modify_for_carriage_return(cls, field_ends, data):
        if field_ends.size == 0 or field_ends[0, 0] < 1:
            return field_ends
        last_chars = data[field_ends[: cls.n_lines_per_entry, 0] - 1]
        if not np.any(np.asarray(last_chars == "\r")):
            return field_ends
        return field_ends - np.asarray(data[field_ends - 1] == "\r")

    @classmethod
    def _validate(cls, data, new_lines):
        header = cls.HEADER
        if data.size == 0 and new_lines.size == 0:
            return
        n_lines = new_lines.size
        n_per = cls.n_lines_per_entry
        assert n_lines % n_per == 0, "Wrong number of lines in buffer"
        header_idxs = new_lines[n_per - 1: -1: n_per] + 1
        bad_headers = np.asarray(data[header_idxs] != header)
        if bool(np.asarray(data[0] != header)) or np.any(bad_headers):
            if bool(np.asarray(data[0] != header)):
                line_number = 0
            else:
                line_number = (int(np.flatnonzero(bad_headers)[0]) + 1) * n_per
            raise FormatException(
                f"Expected header line to start with {header}",
                line_number=line_number)

    def get_data(self) -> BNPDataClass:
        headers = self._buffer_extractor.get_field_by_number(0)
        sequences = self._buffer_extractor.get_field_by_number(1)
        return SequenceEntry(headers, sequences)

    def get_field_by_number(self, i: int, t: Optional[type] = None):
        text = self._buffer_extractor.get_field_by_number(i)
        if t is not None and t != str:
            parser = self._get_parser(t)
            if parser is not None:
                return parser(text)
        return text

    def get_text_field_by_number(self, i: int):
        return self.get_field_by_number(i)

    def get_field_range_as_text(self, start: int, end: int):
        assert end == start + 1
        return self.get_text_field_by_number(start)

    def __getitem__(self, idx):
        return self.__class__(self._buffer_extractor[idx])

    def count_entries(self) -> int:
        return len(self._buffer_extractor)

    def concatenate(self, buffers):
        return self.__class__(TextThroughputExtractor.concatenate(
            [b._buffer_extractor for b in buffers]))

    @classmethod
    def from_data(cls, entries: BNPDataClass) -> EncodedArray:
        columns = [get_column(getattr(entries, field.name), field.type)
                   for field in dataclasses.fields(entries)]
        return cls.join_fields(columns)

    @classmethod
    def join_fields(cls, fields: List[EncodedRaggedArray]) -> EncodedArray:
        field_lengths = np.stack([np.asarray(f.lengths) for f in fields],
                                 axis=-1)
        line_lengths = field_lengths + 1
        for i in range(len(fields)):
            line_lengths[:, i] += cls._line_offsets[i]
        buffer_size = int(line_lengths.sum())
        buf = EncodedArray(np.empty(buffer_size, dtype=np.uint8),
                           BaseEncoding)
        lines = EncodedRaggedArray(buf, line_lengths.ravel())
        step = cls.n_lines_per_entry
        for i, field in enumerate(fields):
            lines[i::step, cls._line_offsets[i]: -1] = field
        lines[0::step, 0] = cls.HEADER
        lines[:, -1] = "\n"
        return buf


class TwoLineFastaBuffer(OneLineBuffer):
    """2-line FASTA (reference: bionumpy/io/one_line_buffer.py:185-193)."""
    HEADER = ">"
    n_lines_per_entry = 2
    dataclass = SequenceEntry
