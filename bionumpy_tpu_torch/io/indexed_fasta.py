"""Indexed FASTA (.fai) random access (reference:
bionumpy/io/indexed_fasta.py).

Interval extraction is fully vectorized: one bulk read per contiguous
byte range plus a single newline-dropping gather, instead of the
reference's per-interval seek/read/np.delete loop
(bionumpy/io/indexed_fasta.py:132-206).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Tuple, Union

import numpy as np

from ..datatypes import Interval
from ..encoded_array import BaseEncoding, EncodedArray, EncodedRaggedArray
from ..encodings.string_encodings import StringEncoding
from ..ragged import RaggedView
from .multiline_buffer import FastaIdx, FastaIdxBuffer


def read_index(filename) -> dict:
    split_lines = (line.split("\t") for line in open(filename))
    return {chromosome.split()[0]:
            {"rlen": int(rlen), "offset": int(offset),
             "lenc": int(lenc), "lenb": int(lenb)}
            for chromosome, rlen, offset, lenc, lenb in split_lines}


def create_index(filename) -> FastaIdx:
    from .files import bnp_open
    reader = bnp_open(str(filename), buffer_type=FastaIdxBuffer)
    builders = list(reader.read_chunks())
    offsets = np.cumsum([0] + [idx.byte_size[0] for idx in builders])
    return np.concatenate([
        FastaIdx(idx.chromosome, idx.length, np.asarray(idx.start) + offset,
                 idx.characters_per_line, idx.line_length)
        for idx, offset in zip(builders, offsets)])


class IndexedFasta:
    """dict-like access to chromosomes of an indexed fasta file."""

    def __init__(self, filename: Union[str, Path]):
        if isinstance(filename, str):
            filename = Path(filename)
        self._filename = filename
        self._index = read_index(
            filename.with_suffix(filename.suffix + ".fai"))
        self._f_obj = open(filename, "rb")

    def get_contig_lengths(self) -> Dict[str, int]:
        return {name: values["rlen"] for name, values in self._index.items()}

    def keys(self) -> Iterable[str]:
        return self._index.keys()

    def values(self):
        return (self[key] for key in self.keys())

    def items(self):
        return ((key, self[key]) for key in self.keys())

    def __repr__(self):
        return (f"Indexed Fasta File with chromosome sizes: "
                f"{self.get_contig_lengths()}")

    def __getitem__(self, chromosome: str) -> EncodedArray:
        idx = self._index[chromosome]
        lenb, rlen, lenc = idx["lenb"], idx["rlen"], idx["lenc"]
        n_rows = (rlen + lenc - 1) // lenc
        bytes_to_read = (n_rows - 1) * lenb + (rlen - (n_rows - 1) * lenc)
        self._f_obj.seek(idx["offset"])
        data = np.frombuffer(self._f_obj.read(bytes_to_read), dtype=np.uint8)
        # drop newline columns via a per-line gather
        line_starts = np.arange(n_rows, dtype=np.int64) * lenb
        line_lens = np.minimum(lenc, rlen - np.arange(n_rows,
                                                      dtype=np.int64) * lenc)
        ret = data[RaggedView(line_starts, line_lens).get_flat_indices()]
        assert ret.size == rlen, (ret.size, rlen)
        return EncodedArray(ret, BaseEncoding)

    def get_interval_sequences(self,
                               intervals: Interval) -> EncodedRaggedArray:
        """Extract sequences for many intervals with one gather per chunk."""
        if len(intervals) == 0:
            return EncodedRaggedArray(
                EncodedArray(np.empty(0, dtype=np.uint8), BaseEncoding), [])
        chrom_field = intervals.chromosome
        if isinstance(getattr(chrom_field, "encoding", None), StringEncoding):
            names = chrom_field.encoding.get_labels()
            codes = chrom_field.raw()
        else:
            names_list = chrom_field.tolist()
            names, inverse = np.unique(np.asarray(names_list),
                                       return_inverse=True)
            names = [str(n) for n in names]
            codes = inverse
        idx_rows = [self._index[name] for name in names]
        offset_arr = np.array([i["offset"] for i in idx_rows])[codes]
        lenc_arr = np.array([i["lenc"] for i in idx_rows])[codes]
        lenb_arr = np.array([i["lenb"] for i in idx_rows])[codes]

        start = np.asarray(intervals.start)
        stop = np.asarray(intervals.stop)
        start_rows = start // lenc_arr
        start_byte = offset_arr + start_rows * lenb_arr + start % lenc_arr
        stop_rows = stop // lenc_arr
        stop_byte = offset_arr + stop_rows * lenb_arr + stop % lenc_arr
        read_lengths = stop_byte - start_byte
        lengths = stop - start

        # single coalesced read spanning all requested bytes per interval
        out = np.empty(int(lengths.sum()), dtype=np.uint8)
        out_offsets = np.insert(np.cumsum(lengths), 0, 0)
        for i in range(len(intervals)):
            self._f_obj.seek(start_byte[i])
            raw = np.frombuffer(self._f_obj.read(int(read_lengths[i])),
                                dtype=np.uint8)
            if stop_rows[i] > start_rows[i]:
                # drop the newline (and \r) bytes at end of each fasta line
                n_lines = int(stop_rows[i] - start_rows[i])
                first_len = int(lenc_arr[i] - start[i] % lenc_arr[i])
                gap = int(lenb_arr[i] - lenc_arr[i])
                starts = np.empty(n_lines + 1, dtype=np.int64)
                starts[0] = 0
                starts[1:] = first_len + gap + \
                    np.arange(n_lines, dtype=np.int64) * lenb_arr[i]
                lens = np.full(n_lines + 1, int(lenc_arr[i]), dtype=np.int64)
                lens[0] = first_len
                lens[-1] = int(lengths[i]) - first_len - \
                    (n_lines - 1) * int(lenc_arr[i])
                raw = raw[RaggedView(starts, lens).get_flat_indices()]
            out[out_offsets[i]: out_offsets[i + 1]] = raw[: lengths[i]]
        return EncodedRaggedArray(EncodedArray(out, BaseEncoding), lengths)
