"""Sequence operations: k-mers, minimizers, count tables and position
weight matrices."""
from .count_encoded import EncodedCounts, SparseEncodedCounts, count_encoded
from .kmers import KmerEncoder, count_kmers, get_kmers
from .minimizers import (Minimizers, count_minimizers,
                         count_minimizers_with_gc, get_minimizers)
from .position_weight_matrix import (PWM, PositionWeightMatrix,
                                     get_motif_matches, get_motif_scores)

__all__ = ["count_kmers", "get_kmers", "get_minimizers", "count_minimizers",
           "count_minimizers_with_gc", "get_motif_scores",
           "get_motif_matches", "count_encoded", "EncodedCounts",
           "SparseEncodedCounts", "KmerEncoder", "Minimizers", "PWM",
           "PositionWeightMatrix"]
