"""Sequence operations: k-mers, count tables and position weight
matrices."""
from .count_encoded import EncodedCounts, SparseEncodedCounts, count_encoded
from .kmers import count_kmers, get_kmers
from .position_weight_matrix import PWM

__all__ = ["count_kmers", "get_kmers", "count_encoded", "EncodedCounts",
           "SparseEncodedCounts", "PWM"]
