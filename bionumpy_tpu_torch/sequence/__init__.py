"""Sequence operations: k-mers, minimizers, count tables, position
weight matrices, translation, reverse complements, string matching and
transcript sequences."""
from .count_encoded import EncodedCounts, SparseEncodedCounts, count_encoded
from .dna import (get_reverse_complement, get_sequences,
                  get_strand_specific_sequences)
from .kmers import KmerEncoder, count_kmers, get_kmers, kmer_spectrum
from .minimizers import (Minimizers, count_minimizers,
                         count_minimizers_with_gc, get_minimizers)
from .position_weight_matrix import (PWM, PositionWeightMatrix,
                                     get_motif_matches, get_motif_scores)
from .string_matcher import match_string
from .translate import translate_dna_to_protein
from .genes import get_transcript_sequences

__all__ = ["count_kmers", "get_kmers", "kmer_spectrum", "get_minimizers", "count_minimizers",
           "count_minimizers_with_gc", "get_motif_scores",
           "get_motif_matches", "count_encoded", "EncodedCounts",
           "SparseEncodedCounts", "KmerEncoder", "Minimizers", "PWM",
           "PositionWeightMatrix", "translate_dna_to_protein",
           "get_reverse_complement", "get_strand_specific_sequences",
           "get_sequences", "match_string", "get_transcript_sequences"]
