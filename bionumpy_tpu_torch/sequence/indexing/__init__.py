"""K-mer and wildcard indexes over sequence sets."""
from .kmer_indexing import KmerIndex, KmerLookup
from .wildcard_index import WildCardIndex, WildCardLookup

__all__ = ["KmerIndex", "KmerLookup", "WildCardIndex", "WildCardLookup"]
