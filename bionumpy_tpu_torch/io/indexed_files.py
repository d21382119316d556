"""Indexed random-access files (reference: bionumpy/io/indexed_files.py)."""
from __future__ import annotations

import os
from pathlib import PurePath

from .delimited_buffers import DelimitedBuffer
from .indexed_fasta import IndexedFasta, create_index
from .multiline_buffer import FastaIdx


class IndexBuffer(DelimitedBuffer):
    sep = "\t"
    dataclass = FastaIdx


def open_indexed(filename: str) -> IndexedFasta:
    """Open an indexed fasta file; create the .fai if missing."""
    from .files import bnp_open
    path = PurePath(filename)
    suffix = path.suffixes[-1]
    index_file_name = path.with_suffix(path.suffix + ".fai")
    if suffix in (".fa", ".fasta", ".fna"):
        if not os.path.isfile(index_file_name):
            index = create_index(path)
            bnp_open(str(index_file_name), "w",
                     buffer_type=IndexBuffer).write(index)
        return IndexedFasta(filename)
    raise ValueError(
        f"Unknown file type {suffix} for indexed read; only fasta is "
        f"supported")
