"""Element-wise sequence ops on a device: LUT gathers, codon translation
and composition counts (the port's copy of bionumpy_tpu/ops/seq.py).

The JAX package runs these as XLA under jax.jit, with no Pallas kernel;
here they are PyTorch ops on the tensors' device.  Counts are int64
(the JAX package's are int32, which would wrap past 2^31 bases).
Nothing waits for the device: every result stays a tensor until the
caller fetches it.
"""
from __future__ import annotations

import torch

WORD_BASES = 16  # 2-bit codes per packed word
_PAIRS_LOW = 0x55555555  # the low bit of each 2-bit pair of a word

__all__ = ["composition_counts", "composition_from_packed", "lut_gather",
           "encode_with_validation", "translate_codons"]


def composition_counts(codes: torch.Tensor, valid: torch.Tensor,
                       n_symbols: int) -> torch.Tensor:
    """int64 (n_symbols,) count of each code among the valid positions of
    a flat code buffer; invalid positions (and codes >= n_symbols, which
    the JAX package's scatter drops) go to a dump bin that is dropped."""
    index = torch.where(valid, codes.to(torch.int64).clamp(max=n_symbols),
                        n_symbols)
    counts = torch.zeros(n_symbols + 1, dtype=torch.int64,
                         device=codes.device)
    ones = torch.ones(1, dtype=torch.int64, device=codes.device)
    counts.index_add_(0, index.reshape(-1), ones.expand(index.numel()))
    return counts[:n_symbols]


def _pair_popcounts(x: torch.Tensor) -> torch.Tensor:
    """int64 total of the set bits of each row of a 2-D int32 tensor whose
    set bits are all even (the low bit of a 2-bit pair): SWAR sums of the
    pairs into nibbles and of the nibbles into bytes, then the bytes
    summed.  `>>` on int32 sign-extends, so every shift is masked."""
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return x.view(torch.uint8).sum(1, dtype=torch.int64)


def composition_from_packed(words: torch.Tensor, n_true: int) -> torch.Tensor:
    """int64 (4,) counts of the codes 0-3 among the first `n_true`
    positions of 2-bit packed words (the int32 view of n_positions/16
    data words plus two halo words, as the k-mer kernels take them).

    One pass over the words that hold those positions, none over the
    positions: a pair's low bit is set for codes 1 and 3, its high bit
    for 2 and 3, so with L, H the popcounts of the low and the high bits
    and B that of both, the counts are (n_true - L - H + B, L - B, H - B,
    B).  The last, partial word is masked to its positions below n_true:
    bits past n_true need not be zero."""
    n_full, rem = divmod(int(n_true), WORD_BASES)
    data = words[: n_full + (rem > 0)]
    low = data & _PAIRS_LOW
    high = (data >> 1) & _PAIRS_LOW
    if rem:
        keep = (1 << (2 * rem)) - 1
        low[-1:] &= keep
        high[-1:] &= keep
    pops = _pair_popcounts(torch.stack([low, high, low & high]))
    n_low, n_high, n_both = pops[0], pops[1], pops[2]
    return torch.stack([n_true - n_low - n_high + n_both, n_low - n_both,
                        n_high - n_both, n_both])


def lut_gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table[codes]: encode, decode or complement through a lookup table."""
    return table[codes.to(torch.int64)]


def encode_with_validation(table: torch.Tensor, bytes_: torch.Tensor):
    """(codes, offset): table[bytes_] and the flat offset of the first
    code 255 (invalid) as an int64 device scalar, or -1 if there is none."""
    codes = table[bytes_.to(torch.int64)]
    invalid = (codes == 255).reshape(-1)
    # argmax takes no bool tensor; on ties it gives the first index
    first = torch.argmax(invalid.to(torch.uint8))
    return codes, torch.where(invalid.any(), first, -1)


def translate_codons(codes: torch.Tensor,
                     amino_table: torch.Tensor) -> torch.Tensor:
    """Flat TCAG codes, their count divisible by 3 -> amino acid bytes:
    amino_table at c2 + 4 c1 + 16 c0 for each codon (c0, c1, c2), the
    reference's little-endian hash of the reversed codon
    (bionumpy/sequence/translate.py:12-78)."""
    codons = codes.reshape(-1, 3)
    index = codons[:, 0].to(torch.int32)
    index.mul_(4).add_(codons[:, 1]).mul_(4).add_(codons[:, 2])
    return amino_table.index_select(0, index)
