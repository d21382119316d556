"""Chunked file reader/writer (the port's copy of
bionumpy_tpu/io/parser.py; reference: bionumpy/io/parser.py:36-318).

Host-side input: reads raw byte chunks, grows them until at least one
complete entry is present, and carries the incomplete tail to the next
chunk (seek-back for plain files, prepend for gzip streams).  The buffers
it yields hold flat uint8 arrays; the calls on their records move them to
the card.
"""
from __future__ import annotations

import logging
from typing import IO, Iterable, Union

import numpy as np

from ..bnpdataclass import BNPDataClass
from ..encoded_array import EncodedArray
from ..streams import BnpStream, grouped_stream
from .exceptions import FormatException
from .file_buffers import FileBuffer

logger = logging.getLogger(__name__)


def repr_bytes(n: int) -> str:
    if n < 10 ** 4:
        return f"{n}b"
    if n < 10 ** 7:
        return f"{n // 1000}kb"
    if n < 10 ** 11:
        return f"{n // 1000000}Mb"
    return f"{n // 1000000000}Gb"


class NumpyFileReader:
    """Reads chunks of complete entries from a file object."""

    def __init__(self, file_obj: IO, buffer_type: FileBuffer,
                 has_header: bool = False):
        self._file_obj = file_obj
        self._is_finished = False
        self._buffer_type = buffer_type
        self._has_header = has_header
        self._f_name = getattr(file_obj, "name", str(file_obj))
        self._header_data = self._buffer_type.read_header(self._file_obj)
        self._buffer_type = self._buffer_type.modify_class_with_header_data(
            self._header_data)
        self._do_prepend = False
        self._prepend = []
        self.n_bytes_read = 0
        self.n_lines_read = 0

    @property
    def buffer_type(self):
        return self._buffer_type

    @property
    def header_data(self):
        return self._header_data

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self._file_obj.close()

    def __iter__(self):
        return self.read_chunks()

    def close(self):
        self._file_obj.close()

    def set_prepend_mode(self):
        """Gzip streams can't seek backwards; carry leftovers forward."""
        self._do_prepend = True

    def read(self):
        read_array = getattr(self._file_obj, "read_array", None)
        if read_array is not None:  # pgzip.ArrayStream: zero-copy view
            chunk = read_array()
        else:
            chunk = np.frombuffer(self._file_obj.read(), dtype=np.uint8)
        if chunk.size == 0:
            return None
        chunk, _ = self._add_newline_to_end(chunk, chunk.size)
        return self._buffer_type.from_raw_buffer(
            chunk, header_data=self._header_data)

    def _offset_format_errors(self, fn, *args, **kwargs):
        """Run a buffer-type parse callback, shifting any
        FormatException's line number by the lines already consumed so
        error messages point into the FILE, not the chunk."""
        try:
            return fn(*args, **kwargs)
        except FormatException as e:
            e.line_number += self.n_lines_read
            raise

    def _grow_until_complete(self, min_chunk_size, max_chunk_size):
        """Accumulate raw pieces (starting from any carried-over tail)
        until the buffer type sees >= 1 complete entry.  Returns
        (pieces, premade_buffer_or_None); pieces == [] means EOF with
        nothing left."""
        pieces = [self._prepend] if len(self._prepend) else []
        premade = None
        total = sum(p.size for p in pieces)
        while True:
            piece = self._get_buffer(min_chunk_size, max_chunk_size)
            if piece is None:
                # EOF: whatever we carry is the final (partial) chunk
                return (pieces if total else []), premade
            pieces.append(piece)
            total += piece.size
            if max_chunk_size is not None and total > max_chunk_size:
                raise RuntimeError("No complete entry found within "
                                   "max_chunk_size")
            found = self._offset_format_errors(
                self._buffer_type.contains_complete_entry, pieces)
            if isinstance(found, tuple):
                found, premade = found
            if found:
                return pieces, premade

    def read_chunk(self, min_chunk_size: int = 5_000_000,
                   max_chunk_size: int = None) -> FileBuffer:
        pieces, premade = self._grow_until_complete(min_chunk_size,
                                                    max_chunk_size)
        if not pieces:
            return None
        one_piece = len(pieces) == 1
        chunk = pieces[0] if one_piece else np.concatenate(pieces)
        if premade is not None and one_piece:
            buff = premade
        else:
            buff = self._offset_format_errors(
                self._buffer_type.from_raw_buffer, chunk,
                header_data=self._header_data)
        self._stash_unconsumed(chunk, buff.size)
        if not chunk.size:
            return None
        self.n_bytes_read += buff.size
        self.n_lines_read += buff.n_lines
        return buff

    def _stash_unconsumed(self, chunk, n_consumed: int):
        """Return the bytes past the last complete entry to the source:
        seek back for plain files, carry forward for gzip streams."""
        self._prepend = []
        if self._is_finished:
            return
        if self._do_prepend:
            self._prepend = chunk[n_consumed:]
        else:
            self._file_obj.seek(n_consumed - chunk.size, 1)

    def read_chunks(self, min_chunk_size: int = 5_000_000,
                    max_chunk_size: int = None):
        while not self._is_finished or len(self._prepend):
            chunk = self.read_chunk(min_chunk_size, max_chunk_size)
            if chunk is None:
                break
            yield chunk

    def _add_newline_to_end(self, chunk, bytes_read):
        if chunk[bytes_read - 1] != ord("\n"):
            chunk = np.append(chunk, np.uint8(ord("\n")))
            bytes_read += 1
        if hasattr(self._buffer_type, "_new_entry_marker"):
            chunk = np.append(
                chunk, np.uint8(ord(self._buffer_type._new_entry_marker)))
            bytes_read += 1
        return chunk, bytes_read

    def _get_buffer(self, min_chunk_size, max_chunk_size=None):
        raw = np.frombuffer(self._file_obj.read(min_chunk_size),
                            dtype=np.uint8)
        bytes_read = raw.size
        self._is_finished = bytes_read < min_chunk_size
        if bytes_read == 0:
            return None
        if self._is_finished:
            raw, bytes_read = self._add_newline_to_end(raw, bytes_read)
        return raw[:bytes_read]


class NpBufferedWriter:
    """Writes record batches / streams back to a file
    (reference: bionumpy/io/parser.py:209-287)."""

    def __init__(self, file_obj, buffer_type: FileBuffer):
        self._file_obj = file_obj
        self._buffer_type = buffer_type
        self._f_name = getattr(file_obj, "name", str(file_obj))
        self._header_written = False

    def __enter__(self):
        return self

    def __exit__(self, *args):
        if self._file_obj:
            self._file_obj.close()

    def close(self):
        self._file_obj.close()

    def write(self, data: Union[BNPDataClass, BnpStream]):
        if isinstance(data, grouped_stream):
            for _, buf in data:
                if len(buf) > 0:
                    self.write(buf)
            return
        if isinstance(data, BnpStream):
            for buf in data:
                if len(buf) > 0:
                    self.write(buf)
            return
        if hasattr(self._buffer_type, "make_header") and \
                (not hasattr(self._file_obj, "mode") or
                 self._file_obj.mode != "ab"):
            if not self._header_written:
                self._file_obj.write(self._buffer_type.make_header(data))
                self._header_written = True
        if len(data) == 0:
            return
        if hasattr(data, "get_data_object"):
            bytes_array = data.get_buffer(buffer_class=self._buffer_type)
        else:
            bytes_array = self._buffer_type.from_data(data)
        if isinstance(bytes_array, EncodedArray):
            bytes_array = bytes_array.raw()
        self._file_obj.write(bytes(bytes_array))
        logger.debug("Wrote chunk of size %s to %s",
                     repr_bytes(bytes_array.size), self._f_name)


class NumpyBamWriter(NpBufferedWriter):
    EOF_MARKER = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42"
                  b"\x43\x02\x00\x1b\x00\x03\x00\x00\x00\x00\x00\x00\x00"
                  b"\x00\x00")

    def __exit__(self, *args):
        self._file_obj.close()
        with open(self._f_name, "ab") as f:
            f.write(self.EOF_MARKER)


def chunk_lines(stream: Iterable[FileBuffer],
                n_lines: int) -> Iterable[FileBuffer]:
    """Re-chunk buffers to exact line counts (reference:
    bionumpy/io/parser.py:289-318)."""
    cur_buffers = []
    remaining = n_lines
    for chunk in stream:
        n_in_chunk = len(chunk)
        while n_in_chunk >= remaining:
            cur_buffers.append(chunk[:remaining])
            yield np.concatenate(cur_buffers) if len(cur_buffers) > 1 \
                else cur_buffers[0]
            cur_buffers = []
            chunk = chunk[remaining:]
            remaining = n_lines
            n_in_chunk = len(chunk)
        cur_buffers.append(chunk)
        remaining -= n_in_chunk
    if cur_buffers:
        yield np.concatenate(cur_buffers) if len(cur_buffers) > 1 \
            else cur_buffers[0]
