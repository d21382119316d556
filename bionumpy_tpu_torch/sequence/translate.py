"""DNA -> protein translation (the port's copy of
bionumpy_tpu/sequence/translate.py; reference:
bionumpy/sequence/translate.py:12-78).

Flat code buffers of 2^15 codes or more are translated on a device by
ops/seq.translate_codons, as the JAX package routes them; smaller ones
by the same index on the host.  `device=None` is the card, which must
be present; "cpu" runs the torch ops on the host.
"""
from __future__ import annotations

import numpy as np

from ..bnpdataclass.bnpdataclassfunction import apply_to_npdataclass
from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings.alphabet_encoding import AlphabetEncoding
from ..ragged import RaggedShape
from ..streams import streamable

DEVICE_MIN_CODES = 1 << 15  # the JAX package's routing threshold


class DNAToProtein:
    """Codon table indexed by little-endian base-4 hash of the REVERSED
    codon over the TCAG alphabet."""
    amino_acids = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRR"
                   "IIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG")
    from_encoding = AlphabetEncoding("TCAG")
    to_encoding = BaseEncoding
    lookup_table = np.frombuffer(amino_acids.encode("ascii"), dtype=np.uint8)

    def __getitem__(self, kmer_hash):
        return self.lookup_table[np.asarray(kmer_hash)]


class WindowFunction:
    """Base for fixed-window functions over whole-row-multiple windows
    (reference: bionumpy/sequence/translate.py:23-31)."""

    def windowed(self, sequences):
        return self.__call__(sequences)


class Translate(WindowFunction):
    def __init__(self, table=DNAToProtein(), device=None):
        self._table = table
        self._encoding = table.from_encoding
        self._device = device

    @property
    def window_size(self) -> int:
        return 3

    def windowed(self, sequences):
        sequences = as_encoded_array(sequences,
                                     target_encoding=self._encoding)
        was_flat = isinstance(sequences, EncodedArray)
        if was_flat:
            sequences = EncodedRaggedArray(sequences, [len(sequences)])
        if np.any(np.asarray(sequences.lengths) % self.window_size):
            raise ValueError("every sequence length must be a multiple of 3")
        flat = np.asarray(sequences.ravel().raw())
        aminos = self._translate_flat(flat)
        out = EncodedRaggedArray(
            EncodedArray(aminos, self._table.to_encoding),
            RaggedShape(np.asarray(sequences.lengths) // self.window_size))
        if was_flat:
            return out[0]
        return out

    def _translate_flat(self, flat_codes: np.ndarray) -> np.ndarray:
        if flat_codes.size >= DEVICE_MIN_CODES:
            import torch
            from ..ops.device import resolve_device
            from ..ops.seq import translate_codons
            device = resolve_device(self._device)
            out = translate_codons(
                torch.from_numpy(flat_codes).to(device),
                torch.from_numpy(self._table.lookup_table.copy()).to(device))
            return out.cpu().numpy()
        codons = flat_codes.reshape(-1, 3).astype(np.int64)
        index = codons[:, 2] + codons[:, 1] * 4 + codons[:, 0] * 16
        return self._table.lookup_table[index]


@streamable()
@apply_to_npdataclass("sequence")
def translate_dna_to_protein(sequence, device=None):
    """Translate DNA to protein (codons of 3).  `device`: where inputs of
    2^15 codes or more are translated; None is the card.

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> bnp.sequence.translate_dna_to_protein(
    ...     bnp.as_encoded_array(["ATGTTTTGA"]))
    encoded_ragged_array(['MF*'])
    """
    return Translate(device=device).windowed(sequence)
