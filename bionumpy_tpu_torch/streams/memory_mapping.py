"""Memory-mapped persisted encoded ragged arrays (reference:
bionumpy/streams/memory_mapping.py:10-91; the port's copy of
bionumpy_tpu/streams/memory_mapping.py).

The encoding is pickled beside the data, so a package loads only the
files it wrote itself; the .dat files are the same bytes in both."""
from __future__ import annotations

import pickle
from typing import Callable, Iterator

import numpy as np

from ..encoded_array import EncodedArray, EncodedRaggedArray


class MemMapEncodedRaggedArray:
    @classmethod
    def load(cls, basename: str) -> EncodedRaggedArray:
        data = np.memmap(f"{basename}_data.dat", dtype=np.uint8, mode="r")
        lengths = np.memmap(f"{basename}_lengths.dat", dtype=np.int32,
                            mode="r")
        with open(f"{basename}_encoding.pkl", "rb") as f:
            encoding = pickle.load(f)
        return EncodedRaggedArray(EncodedArray(np.asarray(data), encoding),
                                  np.asarray(lengths))

    @classmethod
    def create(cls,
               loader_creator: Callable[[], Iterator[EncodedRaggedArray]],
               basename: str) -> EncodedRaggedArray:
        """Two passes over the loader: size, then write."""
        total_data = 0
        total_rows = 0
        encoding = None
        for chunk in loader_creator():
            total_data += chunk.size
            total_rows += len(chunk)
            encoding = chunk.encoding
        data = np.memmap(f"{basename}_data.dat", dtype=np.uint8, mode="w+",
                         shape=(total_data,))
        lengths = np.memmap(f"{basename}_lengths.dat", dtype=np.int32,
                            mode="w+", shape=(total_rows,))
        data_offset = 0
        row_offset = 0
        for chunk in loader_creator():
            flat = np.asarray(chunk.ravel().raw())
            data[data_offset: data_offset + len(flat)] = flat
            lengths[row_offset: row_offset + len(chunk)] = \
                np.asarray(chunk.lengths)
            data_offset += len(flat)
            row_offset += len(chunk)
        data.flush()
        lengths.flush()
        with open(f"{basename}_encoding.pkl", "wb") as f:
            pickle.dump(encoding, f)
        return EncodedRaggedArray(EncodedArray(np.asarray(data), encoding),
                                  np.asarray(lengths))
