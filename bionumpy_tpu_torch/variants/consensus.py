"""Apply variants to sequences (reference:
bionumpy/variants/consensus.py; the port's copy of
bionumpy_tpu/variants/consensus.py)."""
from __future__ import annotations

import numpy as np

from ..bnpdataclass import replace
from ..encoded_array import EncodedArray


def apply_variants_to_sequence(sequence: EncodedArray,
                               variants) -> EncodedArray:
    """Substitute alt alleles at variant positions (SNVs only)."""
    seq = sequence.copy()
    positions = np.asarray(variants.position)
    assert np.all(np.asarray(seq[positions] == variants.ref_seq.ravel()))
    seq[positions] = variants.alt_seq.ravel()
    return seq


def apply_variants(sequence_entries, variants):
    assert np.all(np.asarray(variants.alt_seq.lengths) == 1)
    return replace(sequence_entries, sequence=[
        apply_variants_to_sequence(
            entry.sequence,
            variants[np.asarray(variants.chromosome == entry.name)])
        for entry in sequence_entries])
