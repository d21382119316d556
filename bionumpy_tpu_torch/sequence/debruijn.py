"""De Bruijn graph over k-mer sets (reference:
bionumpy/sequence/debruin.py:8-74; the port's copy of
bionumpy_tpu/sequence/debruijn.py).  from_sequences takes the k-mers from
get_kmers, which runs the kmer_keys kernel on `device` (None is the
card)."""
from __future__ import annotations

from collections import defaultdict

from ..encoded_array import as_encoded_array
from ..encodings import DNAEncoding
from ..encodings.kmer_encodings import KmerEncoding
from .kmers import get_kmers


class DeBruijnGraph:
    def __init__(self, kmer_set, k):
        self._kmer_set = kmer_set
        self._kmer_encoding = KmerEncoding(DNAEncoding, k)
        self._k = k

    @classmethod
    def from_sequences(cls, sequences, k=31, device=None):
        kmers = get_kmers(as_encoded_array(sequences), k, device=device)
        return cls(set(int(x) for x in kmers.ravel().raw()), k)

    def _get_previous(self, kmer):
        mask = 4 ** self._k - 1
        base = (int(kmer) << 2) & mask
        return [base + i for i in range(4)]

    def _get_next(self, kmer):
        base = int(kmer) >> 2
        return [base + (i << (2 * (self._k - 1))) for i in range(4)]

    @property
    def kmers(self):
        """Sorted k-mer strings in the graph."""
        return sorted(self._kmer_encoding.to_string(k)
                      for k in self._kmer_set)

    def get_contigs(self):
        """Maximal non-branching paths (unitigs) as strings."""
        contigs = []
        visited = set()
        for start in sorted(self._kmer_set):
            if start in visited:
                continue
            s = self._kmer_encoding.to_string(start)
            if len(self.backward(s)) == 1:
                continue  # not a path start
            contig = s
            visited.add(start)
            nxt = self.forward(contig[-len(s):])
            while len(nxt) == 1:
                nxt_str = nxt[0]
                code = int(self._kmer_encoding.encode(nxt_str).raw())
                if code in visited or len(self.backward(nxt_str)) != 1:
                    break
                visited.add(code)
                contig += nxt_str[-1]
                nxt = self.forward(nxt_str)
            contigs.append(contig)
        return contigs

    def forward(self, kmer):
        kmer = int(as_encoded_array(kmer, self._kmer_encoding).raw())
        return [self._kmer_encoding.to_string(n)
                for n in self._get_next(kmer) if n in self._kmer_set]

    def backward(self, kmer):
        kmer = int(as_encoded_array(kmer, self._kmer_encoding).raw())
        return [self._kmer_encoding.to_string(n)
                for n in self._get_previous(kmer) if n in self._kmer_set]


class ColoredDeBruijnGraph:
    """k-mer -> list of sequence indices ("colors") containing it."""

    def __init__(self, color_dict, k):
        self._kmer_encoding = KmerEncoding(DNAEncoding, k)
        self._color_dict = color_dict

    @classmethod
    def from_sequences(cls, sequences, k, device=None):
        kmers = get_kmers(as_encoded_array(sequences), k, device=device)
        colors = defaultdict(list)
        for seq_idx, row in enumerate(kmers.raw().tolist()):
            for kmer in row:
                colors[kmer].append(seq_idx)
        return cls(colors, k)

    def __getitem__(self, idx):
        code = as_encoded_array(idx, self._kmer_encoding).raw()
        return self._color_dict[int(code)]
