"""Generic sliding-window function application (the port's copy of
bionumpy_tpu/sequence/rollable.py).

Host fallback path for non-4-letter alphabets; windows that cross row
boundaries are never materialized (per-row window counts are computed
up front rather than compute-then-trim).
"""
from __future__ import annotations

from abc import abstractmethod

import numpy as np

from ..encoded_array import (EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..ragged import RaggedArray, RaggedShape, RaggedView


class RollableFunction:
    @abstractmethod
    def __call__(self, sequence: EncodedArray):
        raise NotImplementedError

    def rolling_window(self, _sequence, window_size: int = None,
                       mode: str = "valid"):
        if window_size is None:
            window_size = self.window_size
        if getattr(self, "_encoding", None) is not None:
            _sequence = as_encoded_array(_sequence, self._encoding)
        is_ragged = isinstance(_sequence, (RaggedArray, EncodedRaggedArray))
        flat = _sequence.ravel() if is_ragged else _sequence
        raw = flat.raw() if hasattr(flat, "raw") else np.asarray(flat)
        if mode == "valid":
            if raw.shape[-1] < window_size:
                windows = raw[..., np.zeros((0, window_size), np.int64)]
            else:
                # along the last axis, so an array of windows (Minimizers)
                # rolls each window; the JAX package's copy takes 1-D only
                windows = np.lib.stride_tricks.sliding_window_view(
                    raw, window_size, axis=-1)
        elif mode == "same":
            padded = np.append(raw,
                               np.zeros(window_size - 1, dtype=raw.dtype))
            windows = np.lib.stride_tricks.sliding_window_view(padded,
                                                               window_size)
        else:
            raise ValueError(mode)
        if hasattr(flat, "encoding"):
            windows = EncodedArray(windows, flat.encoding)
        convoluted = self(windows)
        conv_raw = convoluted.raw() if hasattr(convoluted, "raw") \
            else np.asarray(convoluted)
        if not is_ragged:
            if window_size == 1 or mode == "same":
                out = convoluted
                if mode == "same" and window_size > 1:
                    conv_raw[-(window_size - 1):] = 0
                return out
            return convoluted
        lengths = np.asarray(_sequence.lengths)
        starts = np.insert(np.cumsum(lengths), 0, 0)[:-1]
        if mode == "valid" and window_size > 1:
            out_lengths = np.maximum(lengths - window_size + 1, 0)
        else:
            out_lengths = lengths
        flat_valid = conv_raw[RaggedView(starts,
                                         out_lengths).get_flat_indices()]
        if mode == "same" and window_size > 1:
            # zero out the trailing w-1 positions of every row
            within = _within(lengths)
            beyond = within > np.repeat(lengths, lengths) - window_size
            flat_valid = np.where(beyond, 0, flat_valid)
        if hasattr(convoluted, "encoding"):
            return EncodedRaggedArray(
                EncodedArray(flat_valid, convoluted.encoding),
                RaggedShape(out_lengths))
        return RaggedArray(flat_valid, RaggedShape(out_lengths))


def _within(lengths: np.ndarray) -> np.ndarray:
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    row_starts = np.empty(len(lengths), dtype=np.int64)
    row_starts[0] = 0
    np.cumsum(lengths[:-1], out=row_starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(row_starts, lengths)
