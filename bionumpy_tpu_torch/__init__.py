"""bionumpy_tpu_torch: the PyTorch + CUDA port of bionumpy_tpu, for one
NVIDIA H100.

The port imports torch, numpy and the standard library only: nothing of
JAX and nothing of the JAX package, whose modules it copies where it
needs them (module names follow the JAX package's).  Its entry points
run on the card unless the caller passes device="cpu", where every
kernel runs its plain PyTorch version.

Ported so far: exact gzip-FASTQ -> k-mer counting
(pipeline.count_kmers_fastq, over host-packed words or raw bytes parsed on
the device) and the streamed k-mer checksum
(ops.kmers.kmer_checksum_streamed), through the hand-written kernels of
csrc/kmers.cu; the gzip-FASTQ motif scan to exact match positions
(pipeline.get_motif_matches_fastq, with PWM and read_jaspar_matrix),
through the hand-written kernel of csrc/pwm.cu; the encoded-array data
model (EncodedArray, EncodedRaggedArray, as_encoded_array,
change_encoding) with the k-mer API on it (get_kmers, count_kmers,
count_encoded), whose arrays upload once per device (ops/resident.py);
on the same arrays, minimizers with the GC track (get_minimizers,
count_minimizers, count_minimizers_with_gc, through kernel 1 and a
windowed min) and motif scans (get_motif_scores, get_motif_matches,
PositionWeightMatrix, read_motif, through the kernel of csrc/pwm.cu);
gzip-FASTQ -> minimizer counts (pipeline.count_minimizers_fastq); codon
translation (translate_dna_to_protein) and composition counts
(ops/seq.py); the rest of the k-mer ops of ops/kmers.py; and the string
and record layer: StringArray, StringEncoding, the bool and VCF
encodings, io/strops and io/regexp, bnpdataclass (with lazy record
classes and io/dump_csv) and the record types of datatypes; the file
layer (bnp.open / read / count_entries / open_indexed over the readers and
writers of io/, with util/ and alignments/cigar), whose chunks feed the
calls above; the stream layer (MultiStream, groupby, the bincount,
histogram, mean and quantile folds), run-length arrays and interval
arithmetic (arithmetics: pileups, with get_pileup_device on the card,
boolean masks, jaccard and forbes), reverse complements
(get_reverse_complement) and the whole-genome binned pileup of a BED file
(pipeline.binned_pileup_bed, with genomic_data.GlobalOffset); the
streamed expression graph (compute, whose folds keep torch partials on
their device), the genomic layer (Genome, GenomicIntervals, GenomicArray,
GenomicSequence, Geometry and the rest of genomic_data), SBS96
mutation-type counting and consensus sequences (variants), k-mer and
wildcard indexes and de Bruijn graphs (sequence.indexing,
sequence.debruijn, through kernel 1), string matching (match_string),
transcript sequences and bloom filters; data-parallel steps and the
four file pipelines' mesh= over a single-process device mesh (parallel:
create_mesh, which may repeat one device); and the host tail: the
simulators (simulate), CliWrapper and run_as_commandline (cli), plot
(plotting) and alignments.msa.  Every name the JAX package exports at
its top level is exported here too.
"""
__version__ = "0.1.0"

from . import instrument
from .encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                            Encoding, EncodedLookup, OneToOneEncoding,
                            as_encoded_array, change_encoding,
                            from_encoded_array)
from .encodings import (AminoAcidEncoding, BamEncoding, CigarEncoding,
                        DNAEncoding, QualityEncoding, RNAEncoding,
                        RNAENcoding, StrandEncoding)
from .encodings.alphabet_encoding import AlphabetEncoding
from .encodings.kmer_encodings import KmerEncoding
from .encodings.string_encodings import StringEncoding
from .ragged import RaggedArray, RaggedShape, RaggedView, ragged_slice
from .string_array import StringArray, as_string_array, string_array
from .io.jaspar import read_jaspar_matrix
from .io.motifs import read_motif
from .ops.kmers import kmer_checksum_streamed
from .pipeline import (AccOverflow, binned_pileup_bed, count_kmers_fastq,
                       count_minimizers_fastq, get_motif_matches_fastq)
from .sequence.count_encoded import (EncodedCounts, SparseEncodedCounts,
                                     count_encoded)
from .sequence.kmers import (KmerEncoder, count_kmers, get_kmers,
                             kmer_spectrum)
from .sequence.minimizers import (Minimizers, count_minimizers,
                                  count_minimizers_with_gc, get_minimizers)
from .sequence.position_weight_matrix import (PWM, PositionWeightMatrix,
                                              get_motif_matches,
                                              get_motif_scores)
from .sequence.translate import translate_dna_to_protein
from .sequence.dna import get_reverse_complement
from .streams import (MultiStream, bincount, groupby, histogram, mean,
                      quantile, streamable)
from .datatypes import (BamEntry, Bed6, GFFEntry, Interval, LocationEntry,
                        SAMEntry, SequenceEntry, SequenceEntryWithQuality,
                        VCFEntry)
from . import datatypes
from .bnpdataclass import replace
from .io.strops import str_equal
from .io import (Bed6Buffer, BedBuffer, FastQBuffer, GFFBuffer,
                 GfaSequenceBuffer, MultiLineFastaBuffer, NarrowPeakBuffer,
                 SAMBuffer, TwoLineFastaBuffer, bnp_open, count_entries,
                 get_bufferclass_for_datatype, open_indexed, read)
from .io.matrix_dump import Matrix
from . import arithmetics
from .computation_graph import compute
from .sequence.string_matcher import match_string
from . import genomic_data
from . import alignments
from . import variants
from . import simulate
from .genomic_data import Genome, GenomicArray, GenomicIntervals
from .cli import CliWrapper, run_as_commandline
from .plotting import plot

open = bnp_open

# the reference exposes npstructures as `bnp.nps`; the ragged package is
# its replacement (reference: bionumpy/__init__.py imports npstructures
# as nps)
from . import ragged as nps  # noqa: E402


def set_backend(lib):
    """The reference swaps numpy for cupy via module monkey-patching
    (bionumpy/__init__.py:47-95).  The port computes with PyTorch on the
    card: there is no backend to swap."""
    raise NotImplementedError(
        "bionumpy_tpu_torch computes with PyTorch on the card, and there "
        "is no numpy/cupy backend to swap; choose where each call runs "
        "with its device= argument (device=\"cpu\" runs the plain "
        "versions on the host)")


__all__ = ["count_kmers_fastq", "kmer_checksum_streamed",
           "get_motif_matches_fastq", "PWM", "read_jaspar_matrix",
           "EncodedArray", "EncodedRaggedArray", "as_encoded_array",
           "change_encoding", "DNAEncoding", "get_kmers", "count_kmers",
           "kmer_spectrum",
           "EncodedCounts", "SparseEncodedCounts", "count_encoded",
           "get_minimizers", "count_minimizers", "count_minimizers_with_gc",
           "Minimizers", "get_motif_scores", "get_motif_matches",
           "PositionWeightMatrix", "count_minimizers_fastq", "read_motif",
           "AccOverflow", "instrument", "translate_dna_to_protein",
           "StringEncoding", "StringArray", "string_array", "as_string_array",
           "datatypes", "Interval", "SequenceEntry", "SequenceEntryWithQuality",
           "VCFEntry", "BamEntry", "SAMEntry", "Bed6", "GFFEntry",
           "LocationEntry", "replace", "str_equal", "open", "bnp_open",
           "read", "count_entries", "open_indexed", "Matrix",
           "get_bufferclass_for_datatype", "TwoLineFastaBuffer",
           "FastQBuffer", "MultiLineFastaBuffer", "BedBuffer", "Bed6Buffer",
           "NarrowPeakBuffer", "GfaSequenceBuffer", "GFFBuffer",
           "SAMBuffer", "MultiStream", "bincount", "groupby", "histogram",
           "mean", "quantile", "streamable", "get_reverse_complement",
           "arithmetics", "binned_pileup_bed", "compute", "match_string",
           "genomic_data", "variants", "Genome", "GenomicArray",
           "GenomicIntervals", "Encoding", "OneToOneEncoding",
           "BaseEncoding", "from_encoded_array", "EncodedLookup",
           "AlphabetEncoding", "AminoAcidEncoding", "BamEncoding",
           "QualityEncoding", "CigarEncoding", "StrandEncoding",
           "KmerEncoding", "RNAEncoding", "RNAENcoding", "RaggedArray",
           "RaggedShape", "RaggedView", "ragged_slice", "plot",
           "alignments", "simulate", "CliWrapper", "run_as_commandline",
           "KmerEncoder"]
