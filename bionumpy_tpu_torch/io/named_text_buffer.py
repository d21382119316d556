"""NAME=value field extraction (VCF INFO column) — reference:
bionumpy/io/named_text_buffer.py:12-96."""
from __future__ import annotations

from typing import List

import numpy as np

from ..encoded_array import EncodedRaggedArray, as_encoded_array
from ..ragged import RaggedArray, RaggedView
from .exceptions import FormatException
from .file_buffers import TextBufferExtractor


class NamedBufferExtractor(TextBufferExtractor):
    """field_starts/field_lens are ragged: each row holds that entry's
    `KEY=value` token spans within the flat text buffer."""

    def __init__(self, data, field_starts: RaggedArray,
                 field_lens: RaggedArray, names: List[str]):
        self._data = data
        self._field_starts = field_starts
        self._field_lens = field_lens
        self._names = names
        self._n_fields = len(names)

    @classmethod
    def concatenate(cls, buffers):
        sizes = np.array([b._data.size for b in buffers])
        offsets = np.insert(np.cumsum(sizes), 0, 0)
        data = np.concatenate([b._data for b in buffers])
        starts = np.concatenate(
            [b._field_starts + int(off)
             for b, off in zip(buffers, offsets)])
        lens = np.concatenate([b._field_lens for b in buffers])
        return cls(data, starts, lens, buffers[0]._names)

    def __getitem__(self, idx):
        return self.__class__(self._data, self._field_starts[idx],
                              self._field_lens[idx], self._names)

    def __len__(self):
        return len(self._field_starts)

    def get_field_by_number(self, number: int, keep_sep=False):
        return self.get_field_by_name(self._names[number], keep_sep=keep_sep)

    def has_field_number(self, number: int):
        return self.has_field_name(self._names[number])

    def has_field_name(self, name: str):
        mask = self.has_field_mask(name)
        return np.asarray(
            RaggedArray(mask.astype(np.int64), self._field_starts.lengths)
            .sum(axis=-1)) > 0

    def has_field_mask(self, name: str) -> np.ndarray:
        """Flat mask over all tokens: does token start with `name=`?"""
        probe_len = len(name) + 1
        starts = np.asarray(self._field_starts.ravel())
        if len(starts) == 0:
            return np.zeros(0, dtype=bool)
        # tokens too close to the end of the buffer can't match
        fits = starts + probe_len <= self._data.size
        lens_ok = np.asarray(self._field_lens.ravel()) >= probe_len
        candidates = fits & lens_ok
        mask = np.zeros(len(starts), dtype=bool)
        if np.any(candidates):
            cand_starts = starts[candidates]
            window = self._data[cand_starts[:, None] + np.arange(probe_len)]
            mask[candidates] = np.asarray(
                window == name + "=").all(axis=-1)
        return mask

    def get_field_by_name(self, name: str, keep_sep=False):
        assert name in self._names, (name, self._names)
        mask = self.has_field_mask(name)
        n_entries = len(self._field_starts)
        if not np.any(mask):
            if keep_sep:
                return EncodedRaggedArray(as_encoded_array(";" * n_entries),
                                          np.ones(n_entries, dtype=int))
            return EncodedRaggedArray(as_encoded_array(""),
                                      np.zeros(n_entries, dtype=int))
        per_row = RaggedArray(mask.astype(np.int64),
                              self._field_starts.lengths)
        line_sums = np.asarray(per_row.sum(axis=-1))
        if np.any(line_sums > 1):
            raise FormatException(
                f"Field {name} found multiple times in buffer",
                line_number=int(np.flatnonzero(line_sums > 1)[0]))
        present = line_sums > 0
        field_starts = np.asarray(self._field_starts.ravel())[mask] + \
            len(name) + 1
        lens = np.asarray(self._field_lens.ravel())[mask] - len(name) - 1
        if keep_sep:
            lens = lens + 1
        starts = np.zeros(n_entries, dtype=np.int64)
        starts[present] = field_starts
        starts = np.maximum.accumulate(starts)
        all_lens = np.zeros(n_entries, dtype=np.int64)
        all_lens[present] = lens
        return EncodedRaggedArray(self._data, RaggedView(starts, all_lens))
