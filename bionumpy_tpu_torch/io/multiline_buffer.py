"""Multi-line FASTA buffer + .fai index building (reference:
bionumpy/io/multiline_buffer.py:15-157)."""
import numpy as np

from ..bnpdataclass import bnpdataclass
from ..datatypes import SequenceEntry
from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                             encoded_array_from_nparray)
from ..ragged import RaggedArray
from .file_buffers import FileBuffer


class MultiLineBuffer(FileBuffer):
    """Base for formats whose entries span a variable number of lines
    (so the lazy per-field machinery does not apply)."""
    SKIP_LAZY = True


class MultiLineFastaBuffer(MultiLineBuffer):
    dataclass = SequenceEntry
    n_characters_per_line = 80
    _new_entry_marker = ">"

    def __init__(self, data, new_lines, new_entries):
        self._new_entries = new_entries
        super().__init__(data, new_lines)

    data = property(lambda self: self._data)
    n_lines = property(lambda self: len(self._new_lines))

    @classmethod
    def contains_complete_entry(cls, chunks) -> bool:
        ends_with_new_line = False
        for chunk in chunks:
            chunk = EncodedArray(chunk, BaseEncoding)
            raw = chunk.raw()
            new_lines = np.flatnonzero(raw[:-1] == ord("\n"))
            new_entries = np.flatnonzero(
                raw[new_lines + 1] == ord(cls._new_entry_marker))
            if new_entries.size >= 1:
                return True
            if ends_with_new_line and raw[0] == ord(cls._new_entry_marker):
                return True
            ends_with_new_line = raw[-1] == ord("\n")
        return False

    @classmethod
    def from_raw_buffer(cls, chunk, header_data=None):
        assert header_data is None, header_data
        chunk = EncodedArray(chunk, BaseEncoding)
        raw = chunk.raw()
        assert raw[0] == ord(cls._new_entry_marker), \
            "Multi-line FASTA must start with '>'"
        new_lines = np.flatnonzero(raw[:-1] == ord("\n"))
        new_entries = np.flatnonzero(
            raw[new_lines + 1] == ord(cls._new_entry_marker))
        if new_entries.size == 0:
            raise RuntimeError(
                f"No complete entry found in {cls.__name__}; "
                f"buffer size ({chunk.size}) may be too low")
        entry_starts = new_lines[new_entries] + 1
        cut_chunk = chunk[: entry_starts[-1]]
        return cls(cut_chunk, new_lines[: new_entries[-1]], new_entries[:-1])

    def _lines_and_entries(self):
        line_starts = np.insert(self._new_lines + 1, 0, 0)
        line_ends = np.append(self._new_lines, self._data.size - 1)
        line_ends = self._modify_ends_for_carriage_returns(line_ends,
                                                           self._data)
        lines = self._move_intervals_to_ragged_array(line_starts, line_ends)
        new_entries = np.insert(self._new_entries + 1, 0, 0)
        n_lines_per_entry = np.diff(
            np.append(new_entries, self._new_lines.size + 1)) - 1
        line_offsets = np.insert(np.cumsum(n_lines_per_entry), 0, 0)
        return lines, new_entries, line_offsets, line_starts, line_ends

    def get_data(self):
        self.validate_if_not()
        lines, new_entries, line_offsets, _, _ = self._lines_and_entries()
        headers = lines[new_entries, 1:]
        mask = np.ones(len(lines), dtype=bool)
        mask[new_entries] = False
        sequence_lines = lines[mask]
        seq_lens = sequence_lines.ends[line_offsets[1:] - 1] - \
            sequence_lines.starts[line_offsets[:-1]]
        sequences = RaggedArray(np.asarray(sequence_lines.ravel().raw()),
                                seq_lens)
        return SequenceEntry(
            headers,
            EncodedRaggedArray(EncodedArray(sequences.ravel(), BaseEncoding),
                               seq_lens))

    def _validate(self):
        self._is_validated = True

    def _modify_ends_for_carriage_returns(self, line_ends, data):
        raw = data.raw()
        if np.any(raw[line_ends[:10] - 1] == ord("\r")):
            return line_ends - (raw[line_ends - 1] == ord("\r"))
        return line_ends

    def count_entries(self):
        return len(self._new_entries) + 1 if self._data.size else 0

    @classmethod
    def from_data(cls, entries) -> EncodedArray:
        name_lengths = entries.name.lengths
        sequence_lengths = entries.sequence.lengths
        n_lines = (sequence_lengths - 1) // cls.n_characters_per_line + 1
        last_length = (sequence_lengths - 1) % cls.n_characters_per_line + 1
        line_lengths = np.full(int(np.sum(n_lines)) + n_lines.size,
                               cls.n_characters_per_line + 1, dtype=np.int64)
        entry_starts = np.insert(np.cumsum(n_lines + 1), 0, 0)
        line_lengths[entry_starts[:-1]] = name_lengths + 2
        line_lengths[entry_starts[1:] - 1] = last_length + 1
        lines = EncodedRaggedArray(
            EncodedArray(np.zeros(int(line_lengths.sum()), dtype=np.uint8),
                         BaseEncoding), line_lengths)
        from ..string_array import StringArray
        names = entries.name
        if isinstance(names, StringArray):
            names = names.to_ragged()
        lines[entry_starts[:-1], 1:-1] = names
        lines[entry_starts[:-1], 0] = cls._new_entry_marker
        idxs = np.delete(np.arange(len(lines)), entry_starts[:-1])
        seq = entries.sequence
        if seq.encoding != BaseEncoding:
            decoded = EncodedArray(
                seq.encoding.decode(seq.ravel()).raw(), BaseEncoding)
        else:
            decoded = seq.ravel()
        lines[idxs, :-1] = EncodedRaggedArray(decoded, line_lengths[idxs] - 1)
        lines[:, -1] = "\n"
        return lines.ravel()


@bnpdataclass
class FastaIdx:
    """One .fai line: the five samtools-faidx columns, in file order."""
    chromosome: str
    length: int
    start: int
    characters_per_line: int
    line_length: int


@bnpdataclass
class FastaIdxBuilder(FastaIdx):
    """FastaIdx plus the raw buffer size (needed to chain per-chunk
    index entries into absolute file offsets)."""
    byte_size: int


class FastaIdxBuffer(MultiLineFastaBuffer):
    """Builds .fai index entries from a FASTA buffer (reference:
    bionumpy/io/multiline_buffer.py:126-157)."""
    dataclass = FastaIdxBuilder

    def get_data(self):
        self.validate_if_not()
        line_starts = np.insert(self._new_lines + 1, 0, 0)
        entry_ends = np.append(self._new_lines, self._data.size - 1)
        line_ends = self._modify_ends_for_carriage_returns(entry_ends,
                                                           self._data)
        lines = self._move_intervals_to_ragged_array(line_starts, line_ends)
        new_entries = np.insert(self._new_entries + 1, 0, 0)
        n_lines_per_entry = np.diff(
            np.append(new_entries, self._new_lines.size + 1)) - 1
        line_offsets = np.insert(np.cumsum(n_lines_per_entry), 0, 0)
        headers = lines[new_entries, 1:]
        mask = np.ones(len(lines), dtype=bool)
        mask[new_entries] = False
        sequence_lines = lines[mask]
        ends = np.cumsum(sequence_lines.lengths)
        starts = np.insert(ends, 0, 0)[:-1]
        seq_lens = ends[line_offsets[1:] - 1] - starts[line_offsets[:-1]]
        seq_starts = line_starts[new_entries + 1]
        seq_line_ends = line_ends[new_entries + 1]
        chars_per_line = seq_line_ends - seq_starts
        line_lens = entry_ends[new_entries + 1] - seq_starts
        return FastaIdxBuilder(headers, seq_lens, seq_starts, chars_per_line,
                               line_lens + 1,
                               [self._data.size] * len(headers))
