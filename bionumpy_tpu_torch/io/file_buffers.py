"""Per-format byte-buffer parser protocol.

The port's copy of bionumpy_tpu/io/file_buffers.py, a re-design of
bionumpy/io/file_buffers.py.  A FileBuffer wraps one chunk of raw file
bytes plus the field-start/length matrices the format scan produced;
field extraction is a pure gather over the flat buffer.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple, Type, Union

import numpy as np

from ..bnpdataclass import BNPDataClass
from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                             Encoding, as_encoded_array)
from ..ragged import RaggedView
from ..string_array import as_string_array
from ..typing import SequenceID
from ..util import is_subclass_or_instance
from .exceptions import FormatException
from .strops import (str_to_float, str_to_float_with_missing, str_to_int,
                     str_to_int_with_missing)

NEWLINE = "\n"


class IncompleteEntryException(Exception):
    pass


def move_intervals_to_digit_array(data: EncodedArray, starts, ends,
                                  fill_value) -> EncodedArray:
    """Right-aligned fixed-width matrix of the intervals, left-filled with
    `fill_value` (reference: bionumpy/io/file_buffers.py:21-31)."""
    if len(starts) == 0:
        return data[np.zeros((0, 0), dtype=np.int64)]
    lens = ends - starts
    max_chars = int(np.max(lens))
    view_starts = ends - max_chars
    indices = np.maximum(view_starts[:, None] + np.arange(max_chars), 0)
    array = data[indices]
    pad_mask = np.arange(max_chars)[None, :] < (max_chars - lens)[:, None]
    array[pad_mask] = fill_value
    return array


def move_intervals_to_right_padded_array(data: EncodedArray, starts, ends,
                                         fill_value,
                                         stop_at=None) -> EncodedArray:
    """Left-aligned fixed-width matrix, right-filled
    (reference: bionumpy/io/file_buffers.py:34-62)."""
    lens = ends - starts
    max_chars = int(np.max(lens)) if len(lens) else 0
    indices = np.minimum(starts[:, None] + np.arange(max_chars),
                         max(data.size - 1, 0))
    array = data[indices]
    if stop_at is not None:
        hit = np.asarray(array == stop_at)
        new_lens = np.argmax(hit, axis=-1) if max_chars else np.zeros(len(lens),
                                                                     dtype=int)
        lens = np.where(new_lens > 0, np.minimum(lens, new_lens), lens)
        max_chars = int(np.max(lens)) if len(lens) else 0
        array = array[:, :max_chars]
    pad_mask = np.arange(max_chars)[None, :] >= lens[:, None]
    array[pad_mask] = fill_value
    return array


class FileBuffer:
    """Base parser protocol (reference:
    bionumpy/io/file_buffers.py:80-271)."""

    _buffer_divisor = 1
    supports_modified_write = True
    COMMENT = 0
    n_lines_per_entry = 1

    def __init__(self, data: EncodedArray, new_lines: np.ndarray):
        self._data = data
        self._new_lines = np.asarray(new_lines)
        self._is_validated = False

    @property
    def data(self) -> EncodedArray:
        return self._buffer_extractor.data

    @property
    def size(self) -> int:
        return self.data.size

    @property
    def header_data(self) -> Any:
        return getattr(self, "_header_data", None)

    @property
    def n_lines(self) -> int:
        raise NotImplementedError

    @staticmethod
    def raise_if(condition, *args, **kwargs):
        if condition:
            raise FormatException(*args, **kwargs)

    @classmethod
    def modify_class_with_header_data(cls, header_data) -> Type["FileBuffer"]:
        return cls

    @classmethod
    def read_header(cls, file_object) -> Optional[str]:
        """Consume comment lines; leave the file pointer at the data
        (reference: bionumpy/io/file_buffers.py:135-166)."""
        if cls.COMMENT == 0:
            return None
        comment = cls.COMMENT
        if isinstance(comment, str):
            comment = ord(comment)
        header = []
        for line in file_object:
            if len(line) == 0 or line[0] != comment:
                file_object.seek(-len(line), 1)
                break
            header.append(line.decode("utf-8"))
        return "".join(header)

    @classmethod
    def from_raw_buffer(cls, raw_buffer: np.ndarray,
                        header_data=None) -> "FileBuffer":
        raise NotImplementedError

    @classmethod
    def from_data(cls, data: BNPDataClass) -> EncodedArray:
        raise NotImplementedError

    def validate_if_not(self):
        if not self._is_validated:
            self._validate()
            self._is_validated = True

    def _validate(self):
        pass

    def get_data(self) -> BNPDataClass:
        raise NotImplementedError

    def _move_intervals_to_2d_array(self, starts, ends, fill_value=0):
        return move_intervals_to_digit_array(self._data, starts, ends,
                                             fill_value)

    def _move_intervals_to_ragged_array(self, starts, ends=None, lens=None):
        if lens is None:
            lens = ends - starts
        return EncodedRaggedArray(self._data, RaggedView(starts, lens))

    def _get_parser(self, field_type):
        from typing import List as TList
        if is_subclass_or_instance(field_type, Encoding) and \
                not isinstance(field_type, type(BaseEncoding)):
            enc = field_type if isinstance(field_type, Encoding) \
                else field_type()
            return lambda x: as_encoded_array(x, enc)
        parsers = {
            str: lambda x: x,
            SequenceID: as_string_array,
            int: str_to_int,
            Optional[int]: str_to_int_with_missing,
            bool: lambda x: str_to_int(x).astype(bool),
            float: str_to_float,
            Optional[float]: str_to_float_with_missing,
            TList[int]: self._parse_split_ints,
            TList[float]: self._parse_split_floats,
            TList[bool]: lambda x: self._parse_split_ints(x, sep="")
            .astype(bool),
        }
        return parsers.get(field_type)

    def _parse_split_ints(self, text: EncodedRaggedArray, sep: str = ","):
        from ..ragged import RaggedArray
        if sep == "":
            flat = text.ravel().raw().astype(np.int64) - ord("0")
            return RaggedArray(flat, text.lengths)
        # the text arrives with keep_sep=True (one trailing field
        # delimiter); drop it, then trim a trailing value separator
        # (bed12 block lists end with ',')
        text = text[:, :-1]
        lengths = text.lengths
        if len(text) and int(lengths.sum()):
            nonzero = lengths > 0
            last_chars = np.zeros(len(text), dtype=np.uint8)
            last_chars[nonzero] = text.ravel().raw()[text.ends[nonzero] - 1]
            trailing = nonzero & (last_chars == ord(sep))
            if np.any(trailing):
                new_lens = lengths - trailing
                text = EncodedRaggedArray(
                    text.ravel(), RaggedView(text.starts, new_lens))
        return _split_rows_to_int_lists(text, sep)

    def _parse_split_floats(self, text: EncodedRaggedArray, sep: str = ","):
        # same keep_sep/trailing-separator handling as _parse_split_ints
        text = text[:, :-1]
        lengths = text.lengths
        if len(text) and int(lengths.sum()):
            nonzero = lengths > 0
            last_chars = np.zeros(len(text), dtype=np.uint8)
            last_chars[nonzero] = text.ravel().raw()[text.ends[nonzero] - 1]
            trailing = nonzero & (last_chars == ord(sep))
            if np.any(trailing):
                text = EncodedRaggedArray(
                    text.ravel(), RaggedView(text.starts,
                                             lengths - trailing))
        return _split_rows_to_float_lists(text, sep)

    @classmethod
    def contains_complete_entry(cls, chunks: List[np.ndarray]) -> bool:
        n_new_lines = sum(int(np.count_nonzero(np.asarray(chunk) == ord(NEWLINE)))
                          for chunk in chunks)
        return n_new_lines >= cls.n_lines_per_entry

    @classmethod
    def process_field_for_write(cls, field_name, value):
        return value


def _tokenize_rows(text: EncodedRaggedArray, sep: str):
    """Split every row of a ragged text array on `sep`, returning flat token
    text plus per-row token counts."""
    from ..ragged import RaggedArray
    lengths = text.lengths
    flat = text.ravel()
    raw = flat.raw()
    is_sep = raw == ord(sep)
    n_seps = np.asarray(RaggedArray(is_sep.astype(np.int64), lengths)
                        .sum(axis=-1))
    counts = np.where(lengths == 0, 0, n_seps + 1)
    # token boundaries: row starts and positions after separators
    starts_list = []
    total_tokens = int(counts.sum())
    if total_tokens == 0:
        return (EncodedRaggedArray(EncodedArray(np.empty(0, np.uint8),
                                                text.encoding), []), counts)
    sep_pos = np.flatnonzero(is_sep)
    token_starts = np.zeros(total_tokens, dtype=np.int64)
    token_ends = np.zeros(total_tokens, dtype=np.int64)
    # For each row: tokens = [start, sep+1 ...] ends = [sep..., end]
    row_token_offsets = np.insert(np.cumsum(counts), 0, 0)
    starts = text.starts
    ends = text.ends
    nonempty = counts > 0
    token_starts[row_token_offsets[:-1][nonempty]] = starts[nonempty]
    # remaining token starts are sep positions + 1
    is_first_token = np.zeros(total_tokens, dtype=bool)
    is_first_token[row_token_offsets[:-1][nonempty]] = True
    token_starts[~is_first_token] = sep_pos + 1
    is_last_token = np.zeros(total_tokens, dtype=bool)
    is_last_token[row_token_offsets[1:][nonempty] - 1] = True
    token_ends[is_last_token] = ends[nonempty]
    token_ends[~is_last_token] = sep_pos
    tokens = EncodedRaggedArray(
        flat, RaggedView(token_starts, token_ends - token_starts))
    return tokens, counts


def _split_rows_to_int_lists(text: EncodedRaggedArray, sep: str):
    from ..ragged import RaggedArray
    tokens, counts = _tokenize_rows(text, sep)
    if tokens.size == 0 and int(counts.sum()) == 0:
        return RaggedArray(np.empty(0, dtype=np.int64), counts)
    values = str_to_int(tokens)
    return RaggedArray(values, counts)


def _split_rows_to_float_lists(text: EncodedRaggedArray, sep: str):
    from ..ragged import RaggedArray
    tokens, counts = _tokenize_rows(text, sep)
    if tokens.size == 0 and int(counts.sum()) == 0:
        return RaggedArray(np.empty(0, dtype=float), counts)
    values = str_to_float(tokens)
    return RaggedArray(values, counts)


class TextBufferExtractor:
    """Field start/length matrices over a flat byte buffer (reference:
    bionumpy/io/file_buffers.py:278-397)."""

    def __init__(self, data: EncodedArray, field_starts: np.ndarray,
                 field_ends: np.ndarray = None, field_lens: np.ndarray = None):
        # exactly one of field_ends / field_lens describes the extents
        assert (field_ends is None) != (field_lens is None), \
            "pass field_ends or field_lens, not both"
        if field_lens is None:
            field_lens = field_ends - field_starts
        self._data = data
        self._field_starts, self._field_lens = field_starts, field_lens
        self._n_fields = field_starts.shape[1]

    data = property(lambda self: self._data)
    n_fields = property(lambda self: self._n_fields)

    def __len__(self):
        return len(self._field_starts)

    def __getitem__(self, idx):
        return self.__class__(self._data,
                              field_starts=self._field_starts[idx],
                              field_lens=self._field_lens[idx])

    def get_field_by_number(self, field_nr: int,
                            keep_sep: bool = False) -> EncodedRaggedArray:
        assert field_nr < self._n_fields, (field_nr, self._n_fields)
        starts = self._field_starts[:, field_nr]
        lens = self._field_lens[:, field_nr]
        if keep_sep:
            lens = lens + 1
        return self._extract_data(lens, starts)

    def _extract_data(self, lens, starts):
        return EncodedRaggedArray(self._data, RaggedView(starts, lens))

    def get_fixed_length_field(self, field_nr,
                               field_length: int) -> EncodedArray:
        starts = self._field_starts[:, field_nr]
        indices = starts[..., None] + np.arange(field_length)
        return self._data[indices]

    def get_padded_field(self, field_nr, stop_at=None) -> EncodedArray:
        starts = self._field_starts[:, field_nr]
        if starts.size == 0:
            return self._data[np.zeros(starts.shape + (0,), dtype=np.int64)]
        lens = self._field_lens[:, field_nr]
        padded = move_intervals_to_right_padded_array(
            self._data, starts.ravel(), (starts + lens).ravel(),
            fill_value="\x00", stop_at=stop_at)
        return padded.reshape(starts.shape + (padded.shape[-1],))

    def parse_int_field(self, field_nr: int):
        """Native one-pass signed-int parse of a column; None means
        "use the digit-matrix path" (no native lib, or an anomalous
        row that needs the checked path's FormatException)."""
        from .. import native
        starts = self._field_starts[:, field_nr]
        if len(starts) == 0:
            return np.empty(0, dtype=np.int64)
        raw = self._data.raw() if hasattr(self._data, "raw") \
            else np.asarray(self._data)
        return native.parse_ints(
            raw, starts, starts + self._field_lens[:, field_nr])

    def get_digit_array(self, field_nr: int):
        starts = self._field_starts[:, field_nr]
        if len(starts) == 0:
            return self._data[np.zeros((0, 0), dtype=np.int64)], None, None
        possible_signs = self._data[starts]
        is_negative = np.asarray(possible_signs == "-")
        is_positive = np.asarray(possible_signs == "+")
        if np.any(is_negative) or np.any(is_positive):
            return self.get_field_by_number(field_nr), is_negative, is_positive
        digit_array = move_intervals_to_digit_array(
            self._data, starts, starts + self._field_lens[:, field_nr],
            fill_value="0")
        return digit_array, None, None

    @classmethod
    def concatenate(cls, buffers: List["TextBufferExtractor"]):
        sizes = np.array([b._data.size for b in buffers])
        offsets = np.insert(np.cumsum(sizes), 0, 0)
        data = np.concatenate([b._data for b in buffers])
        starts = np.concatenate([b._field_starts + off
                                 for b, off in zip(buffers, offsets)])
        lens = np.concatenate([b._field_lens for b in buffers])
        return cls(data, starts, field_lens=lens)


class TextThroughputExtractor(TextBufferExtractor):
    """Extractor that retains entry spans so unmodified text can be
    re-serialized without re-encoding (reference:
    bionumpy/io/file_buffers.py:400-457)."""

    def __init__(self, data: EncodedArray, field_starts: np.ndarray,
                 field_ends: np.ndarray = None, field_lens=None,
                 entry_starts: np.ndarray = None,
                 entry_ends: np.ndarray = None, is_contiguous=True):
        if field_lens is None:
            field_lens = field_ends - field_starts
        super().__init__(data, field_starts, field_lens=field_lens)
        self._entry_starts = entry_starts
        self._entry_ends = entry_ends
        self._is_contiguous = is_contiguous

    @classmethod
    def concatenate(cls, buffers):
        sizes = np.array([b._data.size for b in buffers])
        offsets = np.insert(np.cumsum(sizes), 0, 0)
        data = np.concatenate([b._data for b in buffers])
        starts = np.concatenate([b._field_starts + off
                                 for b, off in zip(buffers, offsets)])
        lens = np.concatenate([b._field_lens for b in buffers])
        entry_starts = np.concatenate([b._entry_starts + off
                                       for b, off in zip(buffers, offsets)])
        entry_ends = np.concatenate([b._entry_ends + off
                                     for b, off in zip(buffers, offsets)])
        return cls(data, starts, field_lens=lens, entry_starts=entry_starts,
                   entry_ends=entry_ends,
                   is_contiguous=all(b._is_contiguous for b in buffers))

    def __getitem__(self, idx):
        return self.__class__(self._data,
                              field_starts=self._field_starts[idx],
                              field_lens=self._field_lens[idx],
                              entry_starts=self._entry_starts[idx],
                              entry_ends=self._entry_ends[idx],
                              is_contiguous=False)

    def _make_contiguous(self):
        lens = self._entry_ends - self._entry_starts
        new_offsets = np.insert(np.cumsum(lens), 0, 0)
        shifts = self._entry_starts - new_offsets[:-1]
        self._data = EncodedRaggedArray(
            self._data, RaggedView(self._entry_starts, lens)).ravel()
        self._field_starts = self._field_starts - shifts[:, None]
        self._entry_starts = new_offsets[:-1]
        self._entry_ends = new_offsets[1:]
        self._is_contiguous = True

    @property
    def data(self) -> EncodedArray:
        if not self._is_contiguous:
            self._make_contiguous()
        return self._data

    def get_fields_by_range(self, from_nr: int = None, to_nr: int = None,
                            keep_sep=False):
        assert from_nr is not None and to_nr is None
        starts = self._field_starts[:, from_nr]
        lens = self._entry_ends - starts
        if not keep_sep:
            lens = lens - 1
        return self._extract_data(lens, starts)
