"""K-mer extraction and counting (the port's copy of
bionumpy_tpu/sequence/kmers.py).

For a 4-letter alphabet the work runs on a device through the kmer_keys
kernel (ops/kmer_kernels.py), over the array's device-resident packed
words (ops/resident.py: one upload per array and device).  Other
alphabets, and count_kmers with an axis, take the host paths, as in the
JAX package.  Hash values are the reference's int64 polynomial hashes
sum(code_i * 4^i).

The public functions take `device`: None is the card, which must be
present; "cpu" runs the kernels' plain versions on the host.  They are
call spans (instrument.call_span), and fetch through
ops/device.fetch_rows.  count_kmers' canonical mode and kmer_spectrum
(GenomeScope's k-mer histogram) have no counterpart in the JAX package.
"""
from __future__ import annotations

import logging

import numpy as np

from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                             as_encoded_array, change_encoding)
from ..encodings import DNAEncoding
from ..encodings.alphabet_encoding import AlphabetEncoding
from ..encodings.exceptions import EncodingError
from ..encodings.kmer_encodings import KmerEncoding
from ..instrument import call_span
from ..ops.device import fetch_rows
from ..ragged import RaggedShape
from ..streams import streamable
from ..util import is_subclass_or_instance
from .count_encoded import EncodedCounts, SparseEncodedCounts, count_encoded
from .rollable import RollableFunction

logger = logging.getLogger(__name__)


def convolution(func):
    """Decorator applying a flat windowed function over a ragged array and
    trimming the window_size-1 garbage windows at each row end
    (reference: bionumpy/sequence/kmers.py:90-103)."""
    def new_func(_sequence, window_size, *args, **kwargs):
        shape, sequence = _sequence.shape, _sequence.ravel()
        convoluted = func(sequence, window_size, *args, **kwargs)
        if not isinstance(shape[-1], np.ndarray):
            out = convoluted.reshape(shape)
        else:
            from ..ragged import RaggedArray
            wrapper = EncodedRaggedArray if \
                isinstance(convoluted, EncodedArray) else RaggedArray
            out = wrapper(convoluted, RaggedShape(shape[-1]))
        if window_size == 1:
            return out
        return out[..., : (-window_size + 1)]

    return new_func


class KmerEncoder(RollableFunction):
    """Hash function object for one k-length window
    (reference: bionumpy/sequence/kmers.py:17-33)."""

    def __init__(self, k: int, alphabet_encoding):
        self.window_size = k
        self._k = k
        self._encoding = alphabet_encoding
        self._alphabet_size = alphabet_encoding.alphabet_size
        self._convolution = self._alphabet_size ** np.arange(
            self._k, dtype=np.int64)

    def __call__(self, sequence: EncodedArray) -> EncodedArray:
        sequence = as_encoded_array(sequence, target_encoding=self._encoding)
        return EncodedArray(
            sequence.raw().astype(np.int64).dot(self._convolution),
            KmerEncoding(self._encoding, self._k))

    def inverse(self, kmer_hash) -> EncodedArray:
        return EncodedArray(
            (np.asarray(kmer_hash)[:, np.newaxis] // self._convolution)
            % self._alphabet_size, self._encoding)

    def sample_domain(self, n: int) -> EncodedArray:
        return EncodedArray(
            np.random.randint(0, self._alphabet_size,
                              size=self._k * n).reshape(n, self._k)
            .astype(np.uint8), self._encoding)


def _as_ragged(sequence) -> EncodedRaggedArray:
    if isinstance(sequence, EncodedArray):
        return EncodedRaggedArray(sequence, [len(sequence)])
    return sequence


def _device_dna_kmers(sequence: EncodedRaggedArray, k: int,
                      device=None) -> EncodedRaggedArray:
    """Device path: the resident packed words -> kmer_keys -> the keys of
    the in-row windows, compacted on the device and fetched in one copy;
    they are the flat values of the result, row after row."""
    from ..ops.kmers import kmer_window_hashes
    from ..ops.resident import device_seqs

    ds = device_seqs(sequence, device)
    live = kmer_window_hashes(ds.words, ds.ends, k, ds.n)
    hashes = fetch_rows(live, rows=live.numel())
    out_lengths = np.maximum(ds.lengths - k + 1, 0)
    return EncodedRaggedArray(
        EncodedArray(hashes, KmerEncoding(sequence.encoding, k)),
        RaggedShape(out_lengths))


@call_span
def get_kmers(sequence, k: int, device=None) -> EncodedRaggedArray:
    """All k-mer hashes per sequence (reference semantics:
    bionumpy/sequence/kmers.py:36-88).  A row shorter than k gives an
    empty row; a flat EncodedArray gives a flat result.

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> seqs = bnp.as_encoded_array(["ACGT", "AC"], bnp.DNAEncoding)
    >>> bnp.get_kmers(seqs, 2, device="cpu")
    encoded_ragged_array([[AC, CG, GT],
     [AC]], 2merEncoding(AlphabetEncoding('ACGT')))
    """
    if not 0 < k < 32:
        raise ValueError(f"k must be in (0, 32), got {k}")
    sequence = as_encoded_array(sequence)
    if sequence.encoding == BaseEncoding:
        try:
            sequence = change_encoding(sequence, DNAEncoding)
        except EncodingError:
            logger.error("Could not encode sequences as DNA; ensure only "
                         "A/C/G/T")
            raise
    if not is_subclass_or_instance(sequence.encoding, AlphabetEncoding):
        raise TypeError("Sequence needs an AlphabetEncoding (e.g. "
                        "DNAEncoding); use bnp.change_encoding first")
    was_flat = isinstance(sequence, EncodedArray)
    sequence = _as_ragged(sequence)
    if sequence.encoding.alphabet_size == 4:
        result = _device_dna_kmers(sequence, k, device)
    else:
        result = KmerEncoder(k, sequence.encoding).rolling_window(sequence)
    if was_flat:
        return result[0] if len(result) else result
    return result


@streamable(sum)
@call_span
def count_kmers(sequence, k: int, axis=None, device=None,
                canonical: bool = False) -> EncodedCounts:
    """Count occurrences of each k-mer (reference:
    bionumpy/sequence/kmers.py:130-145).

    For a 4-letter alphabet, k <= 12 gives dense counts over the 4^k
    labels (label strings for k <= 8, the label codes as a range above),
    and 12 < k < 32 gives a SparseEncodedCounts of the observed k-mers;
    both are counted on the device without fetching the windows.  Counts
    are int64.  A stream of chunks folds with sum.

    `canonical=True` (12 < k < 32, a 4-letter alphabet, no axis) counts
    each window under the lesser of its hash and the hash of its reverse
    complement (the codes 3 - c in reverse order), as `jellyfish count
    -C` does, so a k-mer read from either strand is one row.  The JAX
    package has no such mode.

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> seqs = bnp.as_encoded_array(["ACACG", "ACG"], bnp.DNAEncoding)
    >>> counts = bnp.count_kmers(seqs, 2, device="cpu")
    >>> counts.most_common(3)
    EncodedCounts(alphabet=['AC', 'CG', 'CA'], counts=array([3, 2, 1]), row_names=None)
    >>> int(counts["AC"])
    3
    """
    sequence = as_encoded_array(sequence)
    if canonical:
        if axis is not None:
            raise ValueError("canonical k-mers are counted over the whole "
                             "array: axis must be None")
        sequence = _table_sequence(sequence, k)
    if axis is None and _device_countable(sequence, k):
        return _device_count_kmers(sequence, k, device)
    if axis is None and _device_sparse_countable(sequence, k):
        return _device_count_kmers_sparse(sequence, k, device, canonical)
    kmers = get_kmers(sequence, k, device=device)
    return count_encoded(kmers, axis=axis)


def _device_countable(sequence, k: int) -> bool:
    enc = getattr(sequence, "encoding", None)
    if enc == BaseEncoding:
        return False  # needs re-encoding first; handled by generic path
    return (is_subclass_or_instance(enc, AlphabetEncoding) and
            enc.alphabet_size == 4 and k <= 12)


def _device_count_kmers(sequence, k: int, device=None) -> EncodedCounts:
    from ..ops.kmers import kmer_count_small_packed
    from ..ops.resident import device_seqs

    sequence = _as_ragged(sequence)
    ds = device_seqs(sequence, device)
    counts = fetch_rows(kmer_count_small_packed(ds.words, ds.ends, k,
                                                4 ** k, ds.n), rows=4 ** k)
    encoding = KmerEncoding(sequence.encoding, k)
    # the JAX package lists range(4**k) for k > 8; a range holds the same
    # labels without 4^k Python ints (16.7 M at k = 12) and compares, adds
    # and stacks with that list (count_encoded._same_labels)
    alphabet = encoding.get_labels() if k <= 8 else range(4 ** k)
    return EncodedCounts(alphabet, counts)


def _device_sparse_countable(sequence, k: int) -> bool:
    enc = getattr(sequence, "encoding", None)
    if enc == BaseEncoding:
        return False
    return (is_subclass_or_instance(enc, AlphabetEncoding) and
            enc.alphabet_size == 4 and 12 < k < 32)


def _table_sequence(sequence, k: int):
    """The array as 4-letter codes that _device_sparse_countable admits,
    for a canonical table or a spectrum, which take no other route: a
    BaseEncoding array re-encoded as DNA; raises ValueError outside
    12 < k < 32, where no sparse table of 2k-bit keys is made, and
    TypeError for another alphabet."""
    if not 12 < k < 32:
        raise ValueError(f"canonical k-mer tables and spectra need "
                         f"12 < k < 32, got k={k}")
    if sequence.encoding == BaseEncoding:
        sequence = change_encoding(sequence, DNAEncoding)
    if not _device_sparse_countable(sequence, k):
        raise TypeError("canonical k-mer tables and spectra need a "
                        "4-letter AlphabetEncoding (e.g. DNAEncoding)")
    return sequence


def _table_passes(sequence, device):
    from ..ops.kmers import table_passes
    from ..ops.resident import device_seq_blocks
    return table_passes(device_seq_blocks(_as_ragged(sequence), device))


def _device_count_kmers_sparse(sequence, k: int, device=None,
                               canonical: bool = False
                               ) -> SparseEncodedCounts:
    """Count k-mers whose label space cannot be enumerated (k up to 31):
    the device sorts the window keys and compacts them to a (hash, count)
    table (ops/kmers.sparse_count_tables), so the copy to the host holds
    the DISTINCT k-mers only.  An array that is not one pass
    (ops/kmers.table_passes: past one block whose sort fits the card) is
    counted pass by pass over its resident blocks, the passes' tables
    folded on the card (ops/kmers.blocked_table) at the same first cap.
    One pass stays with sparse_count_tables, the JAX package's op of one
    packed batch.  `canonical`: of the canonical keys."""
    from ..ops.kmers import (KMER_TABLE_CAP, blocked_table, fetched_table,
                             kmer_keys_of, sparse_count_tables)

    passes = _table_passes(sequence, device)
    if len(passes) == 1:
        ds = passes[0][0]
        hashes, counts = sparse_count_tables(ds.words, ds.ends, k, ds.n,
                                             canonical=canonical)
    else:
        hashes, counts = fetched_table(*blocked_table(
            passes, kmer_keys_of(k, canonical), KMER_TABLE_CAP))
    return SparseEncodedCounts(KmerEncoding(sequence.encoding, k), hashes,
                               counts)


@call_span
def kmer_spectrum(sequence, k: int, canonical: bool = True,
                  max_count: int = 10000, cap: int = None,
                  device=None) -> np.ndarray:
    """The k-mer spectrum of a read set, as GenomeScope reads it
    (`jellyfish count -C -m k` then `jellyfish histo`): an int64 array h
    of max_count + 1 bins, h[c] the number of distinct k-mers seen c
    times, h[0] = 0, and every k-mer seen more than max_count times
    counted in h[max_count].

    The table is count_kmers' (12 < k < 32; canonical keys by default,
    `canonical=False` for count_kmers' own), built on the device over the
    array's resident blocks (ops/kmers.blocked_table: one whole_table
    sort, or passes of whole rows folded on the card), first compacted at
    `cap` rows (default ops/kmers.KMER_TABLE_CAP; a `cap` that fits the
    table's distinct k-mers runs no pass twice, where a table past it
    runs its passes again until the accumulator fits, as
    blocked_table says: twice for a 30x read set of a 140 M-base
    genome).  The counts are reduced
    to the spectrum on the device and only the spectrum is fetched, never
    the table.  The JAX package has no such function.

    Examples
    --------
    A read and its reverse complement: three canonical 13-mers, each
    seen twice, where the forward keys see six k-mers once.

    >>> import bionumpy_tpu_torch as bnp
    >>> reads = bnp.as_encoded_array(["ACGGTCATTGCAGCA", "TGCTGCAATGACCGT"],
    ...                              bnp.DNAEncoding)
    >>> bnp.kmer_spectrum(reads, 13, max_count=4, device="cpu")
    array([0, 0, 3, 0, 0])
    >>> bnp.kmer_spectrum(reads, 13, canonical=False, max_count=4,
    ...                   device="cpu")
    array([0, 6, 0, 0, 0])
    """
    from ..ops.kmers import (KMER_TABLE_CAP, blocked_table, kmer_keys_of,
                             table_spectrum)

    if max_count < 1:
        raise ValueError(f"max_count must be at least 1, got {max_count}")
    sequence = _table_sequence(as_encoded_array(sequence), k)
    _, counts = blocked_table(_table_passes(sequence, device),
                              kmer_keys_of(k, canonical),
                              KMER_TABLE_CAP if cap is None else cap)
    return table_spectrum(counts, max_count)
