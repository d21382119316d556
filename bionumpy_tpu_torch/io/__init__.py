"""File input and output: readers, writers and buffer types by format (the
port's copy of bionumpy_tpu/io/__init__.py)."""
from .bam import BamBuffer, BamIntervalBuffer
from .delimited_buffers import (Bed6Buffer, Bed12Buffer, BdgBuffer, BedBuffer,
                                ChromosomeSizeBuffer, DelimitedBuffer,
                                GfaSequenceBuffer, GFFBuffer, GTFBuffer,
                                NarrowPeakBuffer,
                                get_bufferclass_for_datatype)
from .exceptions import FormatException, ParsingException
from .fastq_buffer import FastQBuffer
from .file_buffers import FileBuffer, TextBufferExtractor, \
    TextThroughputExtractor
from .files import bnp_open, buffer_types, count_entries, read
from .indexed_fasta import IndexedFasta, create_index
from .indexed_files import open_indexed
from .multiline_buffer import (FastaIdx, FastaIdxBuffer,
                               MultiLineFastaBuffer)
from .npdataclassreader import NpDataclassReader
from .one_line_buffer import OneLineBuffer, TwoLineFastaBuffer
from .parser import (NpBufferedWriter, NumpyBamWriter, NumpyFileReader,
                     chunk_lines)
from .sam import SAMBuffer
from .vcf_buffers import (PhasedHaplotypeVCFMatrixBuffer,
                          PhasedVCFMatrixBuffer, VCFBuffer, VCFBuffer2,
                          VCFMatrixBuffer, VCFWithInfoAsStringBuffer)
from .wig import WigBuffer
from .pairs import PairsBuffer

__all__ = ["bnp_open", "read", "count_entries", "open_indexed",
           "NpDataclassReader", "NumpyFileReader", "NpBufferedWriter",
           "FileBuffer", "OneLineBuffer", "TwoLineFastaBuffer",
           "FastQBuffer", "MultiLineFastaBuffer", "DelimitedBuffer",
           "BedBuffer", "Bed6Buffer", "Bed12Buffer", "BdgBuffer",
           "NarrowPeakBuffer", "GTFBuffer", "GFFBuffer",
           "ChromosomeSizeBuffer", "GfaSequenceBuffer", "SAMBuffer",
           "BamBuffer", "BamIntervalBuffer", "VCFBuffer", "VCFMatrixBuffer",
           "PhasedVCFMatrixBuffer", "PhasedHaplotypeVCFMatrixBuffer",
           "WigBuffer", "PairsBuffer", "get_bufferclass_for_datatype",
           "IndexedFasta", "create_index", "FormatException",
           "ParsingException", "chunk_lines", "buffer_types"]

from .matrix_dump import read_matrix  # noqa: E402,F401
from .motifs import read_motif  # noqa: E402,F401
