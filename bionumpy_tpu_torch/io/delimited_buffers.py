"""Delimited-text buffers: BED/bedgraph/GTF/GFF/chrom.sizes/CSV…

Re-design of bionumpy/io/delimited_buffers.py:29-600.
One newline+delimiter scan yields an (n_entries, n_fields) start/end
matrix; every typed column parse is then a flat gather + vectorized
numeric decode.
"""
from __future__ import annotations

import dataclasses
import io
import logging
from typing import List, Optional

import numpy as np

from ..bnpdataclass import BNPDataClass, bnpdataclass, make_dataclass
from ..bnpdataclass.lazybnpdataclass import LazyBNPDataClass, create_lazy_class
from ..datatypes import (Bed6, Bed12, BedGraph, ChromosomeSize, GfaPath,
                         GTFEntry, Interval, NarrowPeak, SequenceEntry)
from ..datatypes.gtf import GFFEntry
from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings.alphabet_encoding import DigitEncoding
from ..encodings.exceptions import EncodingError
from ..ragged import RaggedArray
from ..string_array import as_string_array
from ..typing import SequenceID
from .dump_csv import dump_csv, join_columns
from .exceptions import FormatException
from .file_buffers import (FileBuffer, TextBufferExtractor,
                           TextThroughputExtractor, NEWLINE)
from .strops import str_to_int

logger = logging.getLogger(__name__)


class DelimitedBuffer(FileBuffer):
    DELIMITER = "\t"
    COMMENT = "#"
    HAS_UNCOMMENTED_HEADER_LINE = False
    n_lines_per_entry = 1

    def __init__(self, buffer_extractor: TextBufferExtractor,
                 header_data=None):
        self._buffer_extractor = buffer_extractor
        self._header_data = header_data
        self._is_validated = True

    @classmethod
    def from_raw_buffer(cls, chunk: np.ndarray,
                        header_data=None) -> "DelimitedBuffer":
        from ..native import find_positions
        chunk = EncodedArray(chunk, BaseEncoding)
        raw = chunk.raw()
        # ONE native SIMD pass for the newline+delimiter positions (the
        # numpy compare-or-nonzero chain is 3 passes over the chunk)
        delimiters = find_positions(raw, ord(NEWLINE),
                                    ord(cls.DELIMITER))
        entry_ends = np.flatnonzero(raw[delimiters] == ord("\n"))
        if entry_ends.size == 0:
            logger.warning("Found no newlines; chunk size may be too low")
            raise FormatException("no complete line in chunk")
        n_fields = cls._get_n_fields(entry_ends)
        size = delimiters[entry_ends[-1]] + 1
        delimiters = np.insert(delimiters[: entry_ends[-1] + 1], 0, -1)
        if np.ndim(n_fields) == 0:
            if len(delimiters) % n_fields != 1 or np.any(
                    raw[delimiters[n_fields::n_fields]] != ord("\n")):
                bad = np.flatnonzero(
                    raw[delimiters[n_fields::n_fields]] != ord("\n"))
                line_number = int(bad[0]) if len(bad) else \
                    (len(delimiters) - 1) // n_fields
                raise FormatException(
                    f"Irregular number of delimiters per line (expected "
                    f"{n_fields} fields)", line_number=line_number)
        extractor = cls._get_buffer_extractor(chunk[:size], delimiters,
                                              n_fields)
        return cls(extractor, header_data)

    @classmethod
    def _get_n_fields(cls, entry_ends) -> int:
        return int(entry_ends[0]) + 1

    @classmethod
    def _get_buffer_extractor(cls, data, delimiters,
                              n_cols) -> TextThroughputExtractor:
        starts = delimiters[:-1].reshape(-1, n_cols) + 1
        ends = delimiters[1:].reshape(-1, n_cols)
        ends = cls._modify_for_carriage_return(ends, data)
        entry_starts = starts[:, 0]
        entry_ends = ends[:, -1] + 1
        return TextThroughputExtractor(data, starts, field_ends=ends,
                                       entry_starts=entry_starts,
                                       entry_ends=entry_ends)

    @classmethod
    def _modify_for_carriage_return(cls, ends, data):
        if data.size == 0 or ends.size == 0 or ends[0, -1] == 0:
            return ends
        if bool(np.asarray(data[ends[0, -1] - 1] == "\r")):
            ends = ends.copy()
            ends[:, -1] -= np.asarray(data[ends[:, -1] - 1] == "\r")
        return ends

    def concatenate(self, buffers):
        return self.__class__(
            self._buffer_extractor.concatenate(
                [b._buffer_extractor for b in buffers]),
            header_data=self._header_data)

    def __getitem__(self, idx):
        return self.__class__(self._buffer_extractor[idx], self._header_data)

    def get_text(self, col, fixed_length=False, keep_sep=False):
        return self._buffer_extractor.get_field_by_number(col,
                                                          keep_sep=keep_sep)

    @property
    def entries(self):
        """Whole entry lines (incl. trailing newline) as a ragged array
        (reference: bionumpy/io/delimited_buffers.py:90-95)."""
        from ..encoded_array import EncodedRaggedArray
        from ..ragged import RaggedShape, RaggedView
        ex = self._buffer_extractor
        starts = ex._field_starts[:, 0]
        ends = ex._field_starts[:, -1] + ex._field_lens[:, -1] + 1
        data = ex.data
        flat = data.raw()[RaggedView(starts,
                                     ends - starts).get_flat_indices()]
        return EncodedRaggedArray(data.__class__(flat, data.encoding),
                                  RaggedShape(ends - starts))

    @classmethod
    def join_fields(cls, fields_list) -> EncodedArray:
        return join_columns(fields_list, cls.DELIMITER).ravel()

    def get_field_range_as_text(self, *args, **kwargs):
        return self.get_column_range_as_text(*args, **kwargs)

    def get_column_range_as_text(self, col_start, col_end, keep_sep=False):
        assert col_end == col_start + 1
        return self._buffer_extractor.get_field_by_number(col_start)

    @classmethod
    def from_data(cls, data: BNPDataClass) -> EncodedArray:
        if isinstance(data, LazyBNPDataClass):
            return cls.from_data(data.get_data_object())
        data_dict = [(field.type, getattr(data, field.name))
                     for field in dataclasses.fields(data)]
        return dump_csv(data_dict, cls.DELIMITER)

    @classmethod
    def make_header(cls, data: BNPDataClass) -> bytes:
        header = ""
        if data.has_context("header"):
            header = data.get_context("header") or ""
        return bytes(header, "ascii")

    @property
    def actual_dataclass(self):
        return self.dataclass

    def get_data(self) -> BNPDataClass:
        self.validate_if_not()
        columns = {}
        for col_number, field in enumerate(
                dataclasses.fields(self.actual_dataclass)):
            columns[field.name] = self._get_field_by_number(col_number,
                                                            field.type)
        data = self.actual_dataclass(**columns)
        data.set_context("header", self._header_data)
        return data

    def get_field_by_number(self, field_nr: int, field_type: type = object):
        if field_type is object or field_type is None:
            field_type = dataclasses.fields(
                self.actual_dataclass)[field_nr].type
        return self._get_field_by_number(field_nr, field_type)

    def _get_field_by_number(self, col_number: int, field_type):
        if field_type is None:
            return None
        self.validate_if_not()
        try:
            if field_type == int:
                vals = self._buffer_extractor.parse_int_field(col_number)
                if vals is not None:
                    return vals
                digit_array, is_negative, is_positive = \
                    self._buffer_extractor.get_digit_array(col_number)
                if is_negative is None:
                    return self._parse_digit_matrix(digit_array)
                return str_to_int(digit_array, is_negative, is_positive)
            if field_type == SequenceID:
                padded = self._buffer_extractor.get_padded_field(col_number)
                return as_string_array(padded)
            keep_sep = field_type in (List[int], List[float])
            text = self._buffer_extractor.get_field_by_number(
                col_number, keep_sep=keep_sep)
            parser = self._get_parser(field_type)
            assert parser is not None, (self.__class__, field_type)
            parsed = parser(text)
            return parsed
        except EncodingError as e:
            row_number = self._row_of_offset(col_number, e.offset)
            raise FormatException(e.args[0], line_number=row_number)

    def _row_of_offset(self, col_number, offset) -> int:
        text = self._buffer_extractor.get_field_by_number(col_number)
        return int(np.searchsorted(np.cumsum(text.lengths), offset,
                                   side="right"))

    def _parse_digit_matrix(self, digit_array) -> np.ndarray:
        try:
            digits = as_encoded_array(digit_array, DigitEncoding).raw()
        except EncodingError as e:
            row_number = e.offset // max(digit_array.shape[-1], 1)
            raise FormatException(e.args[0], line_number=int(row_number))
        if digits.size == 0:
            return np.zeros(len(digits), dtype=np.int64)
        powers = 10 ** np.arange(digits.shape[-1], dtype=np.int64)[::-1]
        return digits.astype(np.int64).dot(powers)

    def count_entries(self) -> int:
        return len(self._buffer_extractor)

    @property
    def n_lines(self) -> int:
        return len(self._buffer_extractor)


class GfaSequenceBuffer(DelimitedBuffer):
    dataclass = SequenceEntry

    def get_data(self):
        ids = self.get_text(1)
        sequences = self.get_text(2)
        data = SequenceEntry(ids, sequences)
        data.set_context("header", self._header_data)
        return data

    def get_field_by_number(self, field_nr: int, field_type: type = object):
        # column 0 is the 'S' record-type tag; data fields start at 1
        return super().get_field_by_number(field_nr + 1, field_type)

    @classmethod
    def from_data(cls, data: SequenceEntry) -> EncodedArray:
        tags = as_encoded_array(["S"] * len(data))
        columns = [tags, data.name, data.sequence]
        return dump_csv([(str, col) for col in columns])


class GfaPathBuffer(DelimitedBuffer):
    dataclass = GfaPath

    def get_data(self):
        from .strops import split
        name = self.get_text(1)
        nodes_lists = self.get_text(2, keep_sep=True)
        nodes_lists[:, -1] = ","
        lengths = np.asarray((nodes_lists == ",").sum(axis=-1))
        all_node_texts = split(nodes_lists.ravel()[:-1], ",")
        int_text = all_node_texts[:, :-1]
        node_ids = str_to_int(int_text)
        directions = np.where(
            np.asarray(all_node_texts[:, -1] == "+"), 1, -1)
        data = GfaPath(name, RaggedArray(node_ids, lengths),
                       RaggedArray(directions, lengths))
        data.set_context("header", self._header_data)
        return data


def get_bufferclass_for_datatype(_dataclass, delimiter: str = "\t",
                                 has_header: bool = False, comment: str = "#",
                                 sub_delimiter=",") -> type:
    """Generate a DelimitedBuffer class for a custom record type
    (reference: bionumpy/io/delimited_buffers.py:352-437)."""

    class DatatypeBuffer(DelimitedBuffer):
        DELIMITER = delimiter
        COMMENT = comment
        HAS_UNCOMMENTED_HEADER_LINE = has_header
        dataclass = _dataclass

        @classmethod
        def modify_class_with_header_data(cls, columns):
            if not columns:
                return cls
            if not has_header:
                return cls
            fields = dataclasses.fields(cls.dataclass)
            type_dict = {field.name: field.type for field in fields}
            new_fields = [(name, type_dict[name]) if name in type_dict
                          else (name, str) for name in columns]
            permuted = make_dataclass(new_fields,
                                      cls.dataclass.__name__ + "Permuted")

            class NewClass(cls):
                _actual_dataclass = cls.dataclass
                dataclass = permuted
                lazy_class = create_lazy_class(permuted)

            NewClass.__name__ = cls.__name__
            return NewClass

        _actual_dataclass = _dataclass

        def get_data(self) -> BNPDataClass:
            data = super().get_data()
            if self.dataclass is not self._actual_dataclass:
                data = data.astype(self._actual_dataclass)
            return data

        @classmethod
        def read_header(cls, file_object: io.FileIO) -> Optional[List[str]]:
            DelimitedBuffer.read_header.__func__(cls, file_object)
            if not has_header:
                return None
            delim = cls.DELIMITER if isinstance(cls.DELIMITER, str) \
                else chr(cls.DELIMITER)
            return file_object.readline().decode("ascii").strip().split(delim)

        @classmethod
        def make_header(cls, data) -> bytes:
            if not has_header:
                return b""
            return bytes(cls.DELIMITER.join(
                [field.name for field in dataclasses.fields(data)]) + "\n",
                "ascii")

    DatatypeBuffer.__name__ = _dataclass.__name__ + "Buffer"
    DatatypeBuffer.__qualname__ = _dataclass.__qualname__ + "Buffer"
    return DatatypeBuffer


class BedBuffer(DelimitedBuffer):
    dataclass = Interval


# trivial per-format specializations: each is DelimitedBuffer (or a BED
# variant) bound to its record type
class Bed6Buffer(BedBuffer): dataclass = Bed6                     # noqa: E701
class Bed12Buffer(Bed6Buffer): dataclass = Bed12                  # noqa: E701
class BdgBuffer(BedBuffer): dataclass = BedGraph                  # noqa: E701
class NarrowPeakBuffer(DelimitedBuffer): dataclass = NarrowPeak   # noqa: E701
class GTFBuffer(DelimitedBuffer): dataclass = GTFEntry            # noqa: E701
class ChromosomeSizeBuffer(DelimitedBuffer): dataclass = ChromosomeSize  # noqa: E501,E701


class DelimitedBufferWithInernalComments(DelimitedBuffer):
    """Delimited buffer tolerating comment lines inside the data
    (reference: bionumpy/io/delimited_buffers.py:494-592)."""

    @classmethod
    def _calculate_col_starts_and_ends(cls, data, delimiters):
        raw = data.raw()
        comment = cls.COMMENT if isinstance(cls.COMMENT, int) \
            else ord(cls.COMMENT)
        inner = delimiters[:-1]
        comment_mask = (raw[inner] == ord("\n")) & \
            (raw[np.minimum(inner + 1, raw.size - 1)] == comment)
        comment_idx = np.flatnonzero(comment_mask)
        start_delimiters = np.delete(delimiters, comment_idx)[:-1]
        end_delimiters = np.delete(delimiters, comment_idx + 1)
        if raw[0] != comment:
            start_delimiters = np.insert(start_delimiters, 0, -1)
        else:
            end_delimiters = end_delimiters[1:]
        return start_delimiters + 1, end_delimiters

    @classmethod
    def _get_buffer_extractor(cls, data, new_lines) -> TextBufferExtractor:
        raw = data.raw()
        delimiters_mask = raw == ord(cls.DELIMITER)
        delimiters_mask[new_lines] = True
        delimiters = np.append(np.flatnonzero(delimiters_mask), raw.size - 1)
        starts, ends = cls._calculate_col_starts_and_ends(data, delimiters)
        n_fields = next(i for i, d in enumerate(ends)
                        if raw[d] == ord("\n")) + 1
        return TextBufferExtractor(data, starts.reshape(-1, n_fields),
                                   ends.reshape(-1, n_fields))

    @classmethod
    def from_raw_buffer(cls, chunk: np.ndarray, header_data=None):
        chunk = EncodedArray(chunk, BaseEncoding)
        new_lines = np.flatnonzero(chunk.raw() == ord("\n"))
        extractor = cls._get_buffer_extractor(chunk[: new_lines[-1] + 1],
                                              new_lines[:-1])
        return cls(extractor, header_data)


class GFFBuffer(DelimitedBufferWithInernalComments):
    dataclass = GFFEntry
