"""Variant simulation (the port's copy of
bionumpy_tpu/simulate/variants.py; reference:
bionumpy/simulate/variants.py)."""
from __future__ import annotations

import logging
from typing import List

import numpy as np

from ..bnpdataclass import bnpdataclass
from ..datatypes import VCFWithInfoAsStringEntry as VCFEntry
from ..encoded_array import (EncodedArray, EncodedRaggedArray,
                             as_encoded_array, change_encoding,
                             BaseEncoding)
from ..encodings import DNAEncoding
from ..encodings.alphabet_encoding import ACGTnEncoding
from ..ragged import ragged_slice
from ..string_array import StringArray

logger = logging.getLogger(__name__)


@bnpdataclass
class SimulatedVCFEntryWithGenotypes(VCFEntry):
    """The eight VCF columns plus a per-sample genotype-string matrix."""
    genotypes: List[str]


def simulate_variants(genome, snp_prob: float = 0.001,
                      small_indel_prob: float = 0.0001,
                      sv_prob: float = 0.00005,
                      ignore_variants_with_n: bool = True, rng=None,
                      genotype_probs=None, n_samples: int = 0):
    """Yield per-chromosome simulated VCF entries."""
    rng = rng or np.random.default_rng()
    if genotype_probs is None:
        genotype_probs = {"0/0": 0.25, "0/1": 0.25, "1/0": 0.25,
                          "1/1": 0.25}
    chromosomes = genome.genome_context.chrom_sizes
    variant_id_offset = 0
    for chromosome, chromosome_size in chromosomes.items():
        lengths = np.concatenate([
            np.ones(int(chromosome_size * snp_prob)),
            rng.integers(3, 50,
                         size=int(small_indel_prob * chromosome_size)),
            rng.integers(50, 500, size=int(sv_prob * chromosome_size)),
        ]).astype(np.int64)
        too_large = lengths > chromosome_size
        if np.any(too_large):
            lengths[too_large] = chromosome_size - 3
        n_variants = len(lengths)
        positions = rng.integers(1, chromosome_size - lengths - 1,
                                 size=n_variants)
        _, unique = np.unique(positions, return_index=True)
        positions = positions[unique]
        lengths = lengths[unique]
        n_variants = len(positions)
        is_insertion = rng.choice([True, False], n_variants)
        chrom_seq = genome[chromosome]
        first_ref_base = chrom_seq[positions]

        ref_lengths = lengths.copy()
        ref_lengths[is_insertion] = 1
        alt_lengths = lengths.copy()
        alt_lengths[~is_insertion] = 1

        total_alt = int(alt_lengths.sum())
        alt_sequences = EncodedRaggedArray(
            EncodedArray(rng.integers(0, 4, size=total_alt)
                         .astype(np.uint8), ACGTnEncoding), alt_lengths)
        ref_sequences = ragged_slice(chrom_seq, positions,
                                     positions + ref_lengths)

        not_snp = lengths != 1
        alt_sequences[not_snp, 0] = first_ref_base[not_snp]
        ref_sequences[:, 0] = first_ref_base
        snp_refs = ref_sequences[~not_snp, 0]
        new_snp_bases = EncodedArray(
            ((np.asarray(snp_refs.raw()) +
              rng.integers(1, 4, size=int((~not_snp).sum()))) % 4)
            .astype(np.uint8), DNAEncoding)
        new_snp_bases = change_encoding(new_snp_bases, ACGTnEncoding)
        alt_sequences[~not_snp, 0] = new_snp_bases

        variants = VCFEntry(
            chromosome=as_encoded_array([chromosome] * n_variants),
            position=positions,
            id=as_encoded_array(
                [f"simulated{i + variant_id_offset}"
                 for i in range(n_variants)]),
            ref_seq=change_encoding(ref_sequences, BaseEncoding),
            alt_seq=change_encoding(alt_sequences, BaseEncoding),
            quality=as_encoded_array(["."] * n_variants),
            filter=as_encoded_array(["PASS"] * n_variants),
            info=as_encoded_array(["."] * n_variants))
        variant_id_offset += n_variants

        if ignore_variants_with_n:
            has_n = np.asarray((variants.ref_seq == "N").any(axis=-1)) | \
                np.asarray((variants.alt_seq == "N").any(axis=-1))
            variants = variants[~has_n]
        variants = variants[np.argsort(np.asarray(variants.position))]
        if n_samples == 0:
            yield variants
        else:
            genotypes = rng.choice(list(genotype_probs),
                                   size=len(variants) * n_samples,
                                   p=list(genotype_probs.values()))
            genotypes = StringArray(
                genotypes.reshape(len(variants), n_samples))
            yield SimulatedVCFEntryWithGenotypes(
                *(getattr(variants, f) for f in
                  ("chromosome", "position", "id", "ref_seq", "alt_seq",
                   "quality", "filter", "info")),
                genotypes=genotypes)
