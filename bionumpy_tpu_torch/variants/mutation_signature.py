"""Mutation-type (SBS96) signature counting (reference:
bionumpy/variants/mutation_signature.py; the port's copy of
bionumpy_tpu/variants/mutation_signature.py)."""
from __future__ import annotations

import numpy as np

from ..datatypes import Variant
from ..encoded_array import EncodedArray, Encoding, as_encoded_array
from ..encodings import DNAEncoding
from ..ragged import RaggedArray
from ..sequence import count_encoded, get_reverse_complement
from ..sequence.lookup import Lookup


class SNPEncoding:
    """Strand-collapsed 6-class single-nucleotide-substitution code."""
    lookup = Lookup(np.full((4, 4), 255, dtype=np.uint8), DNAEncoding)
    lookup["C", "AGT"] = np.arange(3)
    lookup["G", "TCA"] = np.arange(3)
    lookup["T", "ACG"] = np.arange(3) + 3
    lookup["A", "TGC"] = np.arange(3) + 3
    text = np.array([f"C>{c}" for c in "AGT"] + [f"T>{c}" for c in "ACG"])

    @classmethod
    def to_string(cls, encoded):
        return cls.text[encoded]

    @classmethod
    def decode(cls, encoded):
        """Class labels ('C>A', ...) for encoded SNS codes."""
        return cls.text[np.asarray(encoded)]

    @classmethod
    def encode(cls, snp):
        values = cls.lookup[snp.ref_seq, snp.alt_seq]
        assert not np.any(values == 255)
        return EncodedArray(values, cls)


class MutationTypeEncoding(Encoding):
    """flank-kmer x SNP positional hash; labels like 'A[C>G]T'."""

    def __init__(self, flank: int, encoding=DNAEncoding):
        k = flank * 2 + 1
        self.k = k
        self.h = 4 ** np.arange(k, dtype=np.int64)
        self.h[k // 2 + 1:] = self.h[k // 2: -1]
        self.h[k // 2] = 0
        self.h = self.h[::-1]
        self._encoding = encoding
        self.flank = flank

    def encode(self, seq) -> EncodedArray:
        length = seq.shape[-1]
        assert length == self.k + 4, (seq.shape,)
        kmer_idxs = np.concatenate(
            (np.arange(self.flank), [self.flank + 1],
             np.arange(length - self.flank, length)))
        kmer = as_encoded_array(seq[..., kmer_idxs], self._encoding)
        ref_seq = kmer[..., self.k // 2]
        alt_seq = as_encoded_array(seq[..., self.flank + 3], self._encoding)
        kmer_hashes = np.dot(kmer.raw(), self.h)
        snp_hashes = SNPEncoding.lookup[ref_seq, alt_seq]
        return EncodedArray(kmer_hashes + 4 ** (self.k - 1) * snp_hashes,
                            self)

    def from_flanked_snp(self, kmer, alt_seq, ref_seq=None):
        return encode_snps(kmer, alt_seq, ref_seq)

    def to_string(self, encoded) -> str:
        encoded = int(encoded)
        snp = SNPEncoding.to_string(encoded >> (2 * (self.k - 1)))
        chars = (encoded >> (2 * np.arange(self.k - 1))) & 3
        kmer = "".join(chr(b)
                       for b in self._encoding._decode(chars))[::-1]
        return kmer[: self.k // 2] + "[" + str(snp) + "]" + \
            kmer[self.k // 2:]

    decode = to_string

    def get_labels(self):
        return [self.to_string(c)
                for c in np.arange(4 ** (self.k - 1) * 6)]

    def __eq__(self, other):
        return isinstance(other, MutationTypeEncoding) and \
            self.k == other.k

    def __hash__(self):
        return hash(("MutationTypeEncoding", self.k))


def encode_snps(kmer, alt_seq, true_ref_seq=None) -> EncodedArray:
    """Reverse-complement-normalize (pyrimidine ref) flanked SNPs and hash
    (reference: mutation_signature.py:40-55)."""
    kmer = as_encoded_array(kmer, DNAEncoding)
    if isinstance(kmer, RaggedArray):
        kmer = EncodedArray(kmer.raw().to_numpy_array(), kmer.encoding)
    alt_seq = as_encoded_array(alt_seq.ravel(), DNAEncoding)
    k = kmer.shape[-1]
    ref_seq = kmer[..., k // 2]
    if true_ref_seq is not None:
        assert np.all(np.asarray(
            ref_seq.ravel() ==
            as_encoded_array(true_ref_seq, DNAEncoding).ravel()))
    forward_mask = np.asarray((ref_seq == "C") | (ref_seq == "T"))
    rev = get_reverse_complement(kmer)
    kmer = EncodedArray(
        np.where(forward_mask[:, None], kmer.raw(), rev.raw()),
        kmer.encoding)
    snp_code = SNPEncoding.lookup[ref_seq, alt_seq]
    encoding = MutationTypeEncoding(k // 2)
    kmer_hashes = np.dot(kmer.raw(), encoding.h)
    return EncodedArray(kmer_hashes + 4 ** (k - 1) * snp_code, encoding)


def count_mutation_types_genomic(variants, reference, flank: int = 1,
                                 genotyped: bool = False, genotypes=None):
    """SBS96 counting over genomic variant locations (reference:
    mutation_signature.py:106-120)."""
    alt_lens = variants.get_data_field("alt_seq").lengths
    ref_lens = variants.get_data_field("ref_seq").lengths
    snp_mask = (np.asarray(alt_lens) == 1) & (np.asarray(ref_lens) == 1)
    snps = variants[snp_mask]
    ref_seq = snps.get_data_field("ref_seq")
    if not genotyped and genotypes is None and \
            hasattr(reference, "window_matrix"):
        # dict-backed reference: ONE fixed-width gather around the SNP
        # positions replaces the interval-window machinery (exactness
        # pinned by tests/golden/sbs96_vector.json); falls through when
        # a window would cross a chromosome edge
        try:
            chrom = snps.get_data_field("chromosome")
            positions = np.asarray(snps.get_data_field("position"))
        except (AttributeError, KeyError, TypeError):
            chrom = None
        if chrom is not None:
            kmers = reference.window_matrix(chrom, positions, flank)
            if kmers is not None:
                mask = ~np.any(np.asarray(kmers == "N"), axis=-1)
                hashes = encode_snps(
                    kmers[mask], snps[mask].get_data_field("alt_seq"),
                    ref_seq[mask])
                return count_encoded(hashes)
    windows = snps.get_windows(flank=flank)
    kmers = reference[windows]
    if hasattr(kmers, "ravel") and hasattr(kmers, "lengths"):
        # ragged -> fixed-width matrix, keeping the encoding
        kmers = EncodedArray(kmers.raw().to_numpy_array(), kmers.encoding)
    mask = ~np.any(np.asarray(kmers == "N"), axis=-1)
    hashes = encode_snps(kmers[mask],
                         snps[mask].get_data_field("alt_seq"),
                         ref_seq[mask])
    if not genotyped and genotypes is None:
        return count_encoded(hashes)
    if genotypes is None:
        genotypes = (np.asarray(
            snps[mask].get_data_field("genotypes").raw()) > 0).T
    else:
        genotypes = np.asarray(genotypes)[snp_mask][mask].T
    return count_encoded(hashes, genotypes, axis=-1)


def count_mutation_types(variants: Variant, reference, flank: int = 1):
    """Flat (non-genomic-object) variant counting path."""
    snps = variants[np.asarray(variants.is_snp())]
    positions = np.asarray(snps.position)
    offsets = np.arange(-flank, flank + 1)
    kmer_idx = positions[:, None] + offsets
    ref = as_encoded_array(reference, DNAEncoding)
    kmers = EncodedArray(ref.raw()[kmer_idx], DNAEncoding)
    hashes = encode_snps(kmers, snps.alt_seq, snps.ref_seq)
    return count_encoded(hashes)
