"""FASTQ buffer: 4-line entries (reference:
bionumpy/io/fastq_buffer.py:14-61)."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..datatypes import SequenceEntryWithQuality
from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                             as_encoded_array, change_encoding)
from ..encodings import QualityEncoding
from ..ragged import RaggedShape
from .dump_csv import get_column
from .exceptions import FormatException
from .one_line_buffer import OneLineBuffer


class FastQBuffer(OneLineBuffer):
    """4-line entries: @name / sequence / + / quality; dataclass field 2
    (quality) lives on text line 3."""
    dataclass = SequenceEntryWithQuality
    n_lines_per_entry = 4
    _line_offsets = (1, 0, 0, 0)  # the @ is stripped from names
    _empty_lines = [2]            # '+' separator carries no data
    HEADER = "@"

    # dataclass field index -> extractor line index (the '+' line is
    # skipped, so quality is line 3 rather than 2)
    _FIELD_LINE = {0: 0, 1: 1, 2: 3}

    def get_text_field_by_number(self, i: int) -> EncodedRaggedArray:
        if i == 2:
            return self._buffer_extractor.get_field_by_number(
                self._FIELD_LINE[i])
        return super().get_text_field_by_number(i)

    def get_field_by_number(self, i: int, t: type = None):
        if i == 2:
            return QualityEncoding.encode(self.get_text_field_by_number(i))
        return super().get_field_by_number(i, t)

    def get_data(self):
        seq_entry = super().get_data()
        quality = self.get_field_by_number(2, QualityEncoding)
        return SequenceEntryWithQuality(seq_entry.name, seq_entry.sequence,
                                        quality)

    @classmethod
    def _validate(cls, data, new_lines):
        super()._validate(data, new_lines)
        n_per = cls.n_lines_per_entry
        third_line_starts = new_lines[1::n_per] + 1
        bad = np.asarray(data[third_line_starts] != "+")
        if np.any(bad):
            entry_number = int(np.flatnonzero(bad)[0])
            raise FormatException(
                "Expected '+' at third line of entry",
                line_number=2 + entry_number * n_per)

    @classmethod
    def join_fields(cls, fields: List[EncodedRaggedArray]):
        plus_line = as_encoded_array(["+"] * len(fields[0]))
        return super().join_fields(fields[:2] + [plus_line] + fields[2:])

    @classmethod
    def from_data(cls, entries):
        name_field = get_column(entries.name,
                                dataclasses.fields(entries)[0].type)
        quality = entries.quality
        quality_field = EncodedRaggedArray(
            EncodedArray(QualityEncoding.decode(np.asarray(quality.ravel())),
                         BaseEncoding),
            RaggedShape(quality.lengths))
        sequence_field = change_encoding(entries.sequence, BaseEncoding) \
            if entries.sequence.encoding != BaseEncoding else entries.sequence
        return cls.join_fields([name_field, sequence_field, quality_field])
