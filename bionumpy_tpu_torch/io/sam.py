"""SAM buffer: 11 fixed columns + ragged `extra` tail
(reference: bionumpy/io/buffers/sam.py:27-49)."""
from __future__ import annotations

import numpy as np

from ..datatypes import SAMEntry
from ..ragged import RaggedArray
from .delimited_buffers import DelimitedBuffer
from .file_buffers import TextThroughputExtractor


class SAMBufferExtractor(TextThroughputExtractor):
    def get_field_by_number(self, field_nr: int, keep_sep=False):
        if field_nr == 11:
            return self._get_extra_field()
        return super().get_field_by_number(field_nr, keep_sep)

    def _get_extra_field(self):
        starts = self._field_starts[:, -1] + self._field_lens[:, -1] + 1
        lens = np.maximum(self._entry_ends - starts - 1, 0)
        return self._extract_data(lens, starts)


class SAMBuffer(DelimitedBuffer):
    dataclass = SAMEntry
    COMMENT = "@"

    @classmethod
    def _get_n_fields(cls, entry_ends):
        return np.insert(np.diff(entry_ends), 0, entry_ends[0] + 1)

    @classmethod
    def _get_buffer_extractor(cls, data, delimiters,
                              n_fields) -> TextThroughputExtractor:
        common_fields = 11
        starts_ragged = RaggedArray(delimiters[:-1] + 1, n_fields)
        ends_ragged = RaggedArray(delimiters[1:], n_fields)
        starts = np.stack([np.asarray(starts_ragged[:, i])
                           for i in range(common_fields)], axis=-1)
        ends = np.stack([np.asarray(ends_ragged[:, i])
                         for i in range(common_fields)], axis=-1)
        last_ends = np.asarray(ends_ragged[:, -1])
        entry_starts = starts[:, 0]
        entry_ends = last_ends + 1
        return SAMBufferExtractor(data, starts, field_ends=ends,
                                  entry_starts=entry_starts,
                                  entry_ends=entry_ends)
