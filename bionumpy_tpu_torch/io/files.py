"""File façade: suffix -> buffer type dispatch (reference:
bionumpy/io/files.py:28-246)."""
from __future__ import annotations

import logging
from pathlib import PurePath
from typing import Optional, Union

from ..bnpdataclass import BNPDataClass
from .bam import BamBuffer, BamIntervalBuffer
from .delimited_buffers import (BdgBuffer, BedBuffer, ChromosomeSizeBuffer,
                                GfaSequenceBuffer, GFFBuffer, GTFBuffer,
                                NarrowPeakBuffer)
from .fastq_buffer import FastQBuffer
from .file_buffers import FileBuffer
from .gzip_reading import gzip
from .multiline_buffer import MultiLineFastaBuffer
from .npdataclassreader import NpDataclassReader
from .pairs import PairsBuffer
from .parser import NpBufferedWriter, NumpyBamWriter, NumpyFileReader
from .sam import SAMBuffer
from .vcf_buffers import VCFBuffer
from .wig import WigBuffer

logger = logging.getLogger(__name__)

# default buffer per format family; formats with several customary
# extensions list them all (expanded into the flat suffix map below)
_FORMAT_SUFFIXES = [
    (MultiLineFastaBuffer, (".fa", ".fasta", ".fna", ".faa")),
    (FastQBuffer, (".fq", ".fastq")),
    (BedBuffer, (".bed",)),
    (BdgBuffer, (".bdg",)),
    (NarrowPeakBuffer, (".narrowPeak",)),
    (VCFBuffer, (".vcf",)),
    (GFFBuffer, (".gff", ".gff3")),
    (GTFBuffer, (".gtf",)),
    (GfaSequenceBuffer, (".gfa",)),
    (SAMBuffer, (".sam",)),
    (BamBuffer, (".bam",)),
    (ChromosomeSizeBuffer, (".sizes",)),
    (WigBuffer, (".wig",)),
    (PairsBuffer, (".pairs", ".pa5")),
]

buffer_types = {suffix: buf
                for buf, suffixes in _FORMAT_SUFFIXES
                for suffix in suffixes}


def _effective_suffix(filename) -> tuple:
    """(format suffix, is_gzip): strips a trailing .gz; .bam counts as
    gzip-compressed (BGZF)."""
    suffixes = PurePath(filename).suffixes
    last = suffixes[-1]
    if last == ".gz":
        return suffixes[-2], True
    return last, last == ".bam"


def _get_buffer_type(suffix: str):
    if suffix in buffer_types:
        return buffer_types[suffix]
    names = {buffer.__name__ for buffer in buffer_types.values()}
    raise RuntimeError(
        f"File format {suffix} does not have a default buffer type. "
        f"Specify buffer_type using one of "
        f"{sorted('bnp.' + n for n in names)} or use a valid extension "
        f"{sorted(buffer_types.keys())}")


def _get_buffered_file(filename, suffix, mode, is_gzip=False,
                       buffer_type=None, **kwargs):
    open_func = gzip.open if is_gzip else open
    if buffer_type is None:
        buffer_type = _get_buffer_type(suffix)
    writer_class = NumpyBamWriter if suffix == ".bam" else NpBufferedWriter
    if mode in ("w", "write", "wb"):
        return writer_class(open_func(filename, "wb"), buffer_type)
    if mode in ("a", "append", "ab"):
        return writer_class(open_func(filename, "ab"), buffer_type)
    if is_gzip and suffix != ".bam":
        # multi-member .gz files inflate on a thread pool (io/pgzip.py);
        # single-member files fall back to sequential gzip inside
        from .pgzip import open_gzip
        file_obj = open_gzip(filename)
    else:
        file_obj = open_func(filename, "rb")
    file_reader = NumpyFileReader(file_obj, buffer_type)
    if is_gzip:
        file_reader.set_prepend_mode()
    return NpDataclassReader(file_reader, lazy=kwargs.get("lazy", None))


def bnp_open(filename: str, mode: str = None, buffer_type=None,
             lazy=None) -> Union[NpDataclassReader, NpBufferedWriter]:
    """Open a bioinformatics file according to its suffix.

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> bnp.open("example_data/small_interval.bed").read()[:2]
    Interval with 2 entries
                   chromosome                    start                     stop
                            0                       13                       18
                            0                       37                       46
    """
    suffix, is_gzip = _effective_suffix(filename)
    return _get_buffered_file(filename, suffix, mode, is_gzip=is_gzip,
                              buffer_type=buffer_type, lazy=lazy)


def count_entries(filename: str, buffer_type: FileBuffer = None) -> int:
    """Count entries in a file.

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> bnp.count_entries("example_data/big.fq.gz")
    1000
    """
    logger.info("Counting entries in %s", filename)
    suffix, is_gzip = _effective_suffix(filename)
    open_func = gzip.open if is_gzip else open
    if buffer_type is None:
        buffer_type = _get_buffer_type(suffix)
    file_reader = NumpyFileReader(open_func(filename, "rb"), buffer_type)
    if is_gzip:
        file_reader.set_prepend_mode()
    return sum(chunk.count_entries()
               for chunk in file_reader.read_chunks(min_chunk_size=500_000))


def read(filename: str, mode: str = None,
         buffer_type: Optional[FileBuffer] = None) -> BNPDataClass:
    with bnp_open(filename, mode, buffer_type) as f:
        return f.read()
