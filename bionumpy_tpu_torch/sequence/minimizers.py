"""Minimizers (the port of bionumpy_tpu/sequence/minimizers.py; reference
semantics: bionumpy/sequence/minimizers.py:8-54).

The minimizer of a window of `window_size` bases is the least hash of its
window_size - k + 1 k-mers.  For a 4-letter alphabet the work runs on a
device through kernel 1 and the windowed min of ops/minimizers.py, over
the array's resident packed words (ops/resident.py: one upload per array
and device, shared with the k-mer and motif calls); other alphabets take
the host rollable, as in the JAX package.  The public functions take
`device`: None is the card, which must be present; "cpu" runs the plain
versions on the host.  Tables are fetched as live rows in one copy (the
JAX package ships them in its 32-bit delta pack) through
ops/device.fetch_rows; hashes, counts and GC bins are equal to its
results, dtypes included.  The public functions are call spans
(instrument.call_span); each wait for a table's meta is a `D2H-meta`
span, and each table compacted again past its cap counts as
`cap-rerun`.
"""
from __future__ import annotations

import functools

import numpy as np

from ..encoded_array import (EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings.alphabet_encoding import AlphabetEncoding
from ..encodings.kmer_encodings import KmerEncoding
from ..instrument import add, call_span, stage
from ..ops.device import fetch_rows
from ..ragged import RaggedShape
from ..util import is_subclass_or_instance
from .count_encoded import SparseEncodedCounts
from .kmers import KmerEncoder
from .rollable import RollableFunction


class Minimizers(RollableFunction):
    """Host rollable for alphabets that are not 4 letters (reference:
    bionumpy/sequence/minimizers.py:8-16)."""

    def __init__(self, n_kmers, kmer_encoder: KmerEncoder):
        self._n_kmers = n_kmers
        self._kmer_encoder = kmer_encoder
        self.window_size = n_kmers + kmer_encoder.window_size - 1
        self._encoding = kmer_encoder._encoding

    def __call__(self, sequence):
        kmer_hashes = self._kmer_encoder.rolling_window(sequence)
        return EncodedArray(kmer_hashes.raw().min(axis=-1),
                            kmer_hashes.encoding)


def _checked(sequence, k: int, window_size: int, four_letters: bool):
    """The sequence as an encoded array, checked: an alphabet encoding
    (of 4 letters if `four_letters`) and k <= window_size."""
    sequence = as_encoded_array(sequence)
    enc = sequence.encoding
    if not is_subclass_or_instance(enc, AlphabetEncoding) or \
            (four_letters and enc.alphabet_size != 4):
        raise TypeError("Sequence needs an AlphabetEncoding"
                        + (" of 4 letters" if four_letters else "")
                        + ", e.g. DNAEncoding")
    if not 0 < k <= window_size:
        raise ValueError(f"kmer size {k} must lie in 1..window_size "
                         f"({window_size})")
    return sequence


def _as_ragged(sequence) -> EncodedRaggedArray:
    if isinstance(sequence, EncodedArray):
        return EncodedRaggedArray(sequence, [len(sequence)])
    return sequence


@call_span
def get_minimizers(sequence, k: int, window_size: int,
                   device=None) -> EncodedRaggedArray:
    """Minimum k-mer hash in every window of `window_size` bases.

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> seqs = bnp.as_encoded_array(["ACGTACGT"], bnp.DNAEncoding)
    >>> bnp.get_minimizers(seqs, k=2, window_size=4, device="cpu")
    encoded_ragged_array([[AC, TA, TA, TA, AC]], 2merEncoding(AlphabetEncoding('ACGT')))
    """
    sequence = _checked(sequence, k, window_size, four_letters=False)
    was_flat = isinstance(sequence, EncodedArray)
    sequence = _as_ragged(sequence)
    if sequence.encoding.alphabet_size == 4:
        result = _device_minimizers(sequence, k, window_size, device)
    else:
        result = Minimizers(window_size - k + 1,
                            KmerEncoder(k, sequence.encoding)
                            ).rolling_window(sequence)
    if was_flat:
        return result[0] if len(result) else result
    return result


def _device_minimizers(sequence: EncodedRaggedArray, k: int,
                       window_size: int, device=None) -> EncodedRaggedArray:
    """The minimizer keys of the windows that fit their rows, compacted
    on the device and fetched in one copy: the flat int64 values of the
    result, row after row."""
    from ..ops.minimizers import minimizer_keys_packed, window_valid
    from ..ops.resident import device_seqs

    ds = device_seqs(sequence, device)
    mins = minimizer_keys_packed(ds.words, ds.ends, k, window_size - k + 1,
                                 ds.n)
    valid = window_valid(ds.ends, ds.n_positions, window_size, ds.n)
    live = mins[valid]
    hashes = fetch_rows(live, rows=live.numel())
    out_lengths = np.maximum(ds.lengths - window_size + 1, 0)
    return EncodedRaggedArray(
        EncodedArray(hashes, KmerEncoding(sequence.encoding, k)),
        RaggedShape(out_lengths))


@call_span
def count_minimizers(sequence, k: int, window_size: int,
                     cap: int = 1 << 20, device=None) -> SparseEncodedCounts:
    """Count occurrences of each minimizer (one per window): the device-
    compacted twin of count_encoded(get_minimizers(...)), whose copy to
    the host holds the DISTINCT minimizers only.  A table with more than
    `cap` distinct minimizers is compacted again from the same sort at a
    cap that fits.  An array past one block whose sort fits the card
    (ops/kmers.table_passes; a human genome) is counted pass by pass
    over its resident blocks and the passes' tables are folded on the
    card into one of `cap` rows (ops/kmers.blocked_table); a `cap` below
    its distinct minimizers makes the passes run once more at a cap that
    fits.

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> seqs = bnp.as_encoded_array(["ACGTACGT"], bnp.DNAEncoding)
    >>> c = bnp.count_minimizers(seqs, k=2, window_size=4, device="cpu")
    >>> sorted(zip(c.alphabet, (int(x) for x in c.counts)))
    [('AC', 2), ('TA', 3)]
    """
    from ..ops.kmers import blocked_table, fetched_table, table_passes
    from ..ops.minimizers import minimizer_keys_masked
    from ..ops.resident import device_seq_blocks

    sequence = _as_ragged(_checked(sequence, k, window_size, True))
    n_kmers = window_size - k + 1

    def keys_of(words, ends, n_true):
        return minimizer_keys_masked(words, ends, n_true, k, n_kmers)

    return SparseEncodedCounts(
        KmerEncoding(sequence.encoding, k),
        *fetched_table(*blocked_table(
            table_passes(device_seq_blocks(sequence, device)), keys_of,
            cap)))


@call_span
def count_minimizers_with_gc(sequence, k: int, window_size: int,
                             cap: int = 1 << 20, bin_size: int = 1000,
                             n_chunks: int = 1, chunk_cap: int = None,
                             device=None):
    """count_minimizers AND the GC count per `bin_size` bases of the same
    sequences, from one upload (ops/minimizers.minimizer_gc_job_packed):
    one small fetch of the table's meta, then the live rows and the bins
    in one copy.  Returns (SparseEncodedCounts, int32 array of
    ceil(n / bin_size) bins).

    `n_chunks > 1` splits the rows into ~equal-base chunks, each uploaded
    and counted without a wait, and folds the chunk tables into one
    accumulator of `cap` rows (a ValueError if the job has `cap` or more
    distinct minimizers); `chunk_cap` bounds a chunk's distinct
    minimizers, and a chunk that overflows it makes the chunks rerun once
    at a cap that fits."""
    sequence = _as_ragged(_checked(sequence, k, window_size, True))
    if n_chunks > 1 and len(sequence) >= n_chunks:
        return _count_minimizers_with_gc_chunked(
            sequence, k, window_size, cap, bin_size, n_chunks,
            chunk_cap or max(cap // n_chunks * 2, 1 << 16), device)
    from ..ops.minimizers import minimizer_gc_job_packed
    from ..ops.resident import device_seqs

    ds = device_seqs(sequence, device)
    uniq, counts, _, gc = minimizer_gc_job_packed(
        ds.words, ds.ends, ds.n, k, window_size - k + 1, cap, bin_size)
    n = uniq.numel()
    rows = fetch_rows(uniq, counts, gc[: -(-ds.n // bin_size)], rows=n)
    return (SparseEncodedCounts(KmerEncoding(sequence.encoding, k),
                                rows[:n].view(np.uint64), rows[n: 2 * n]),
            rows[2 * n:].astype(np.int32))


def _count_minimizers_with_gc_chunked(sequence, k: int, window_size: int,
                                      cap: int, bin_size: int,
                                      n_chunks: int, chunk_cap: int,
                                      device=None):
    """The chunked job: each chunk's upload, GC bins and table are
    launched without a wait, the chunk tables fold into one accumulator
    (ops/kmers.fold_tables, one pass a chunk; tables that fit FOLD_ROWS
    together merge once), and the host waits twice, for the metas and
    for one copy of [table rows, every chunk's bins]; the chunks'
    global-grid bins add at their offsets.  The chunks are
    views of the array, packed and uploaded every call."""
    from ..ops.device import bucket_size, flat_and_lengths, resolve_device
    from ..ops.kmers import fold_tables
    from ..ops.minimizers import minimizer_keys_masked
    from ..ops.resident import device_seqs
    from ..ops.tracks import gc_binned_phase

    flat, lengths = flat_and_lengths(sequence)
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    cum = np.cumsum(lengths)
    bounds = [0]
    for g in range(1, n_chunks):
        r = int(np.searchsorted(cum, total * g // n_chunks))
        bounds.append(max(bounds[-1], min(r + 1, len(lengths))))
    bounds.append(len(lengths))
    starts = np.concatenate([[0], cum])[bounds]

    n_kmers = window_size - k + 1
    gcs, offs = [], []

    def chunk_keys(r0, r1, base):
        # the chunk as a view of the flat codes (slicing the ragged array
        # would copy them)
        chunk = EncodedRaggedArray(
            EncodedArray(flat[base: base + int(lengths[r0:r1].sum())],
                         sequence.encoding), lengths[r0:r1])
        ds = device_seqs(chunk, device)
        gcs.append(gc_binned_phase(ds.words, ds.n, bin_size,
                                   base % bin_size))
        offs.append(base // bin_size)
        return minimizer_keys_masked(ds.words, ds.ends, ds.n, k, n_kmers)

    acc_keys, acc_cnt, probe = fold_tables(
        [(chunk_cap, functools.partial(chunk_keys, r0, r1, int(base)))
         for r0, r1, base in zip(bounds[:-1], bounds[1:], starts)
         if r0 < r1],
        cap, chunk_cap, resolve_device(device).type == "cuda")
    with stage("D2H-meta", device=probe.is_cuda):
        probe = probe.cpu().numpy()
    max_unique, nu = int(probe[:-1:2].max()), int(probe[-1])
    if max_unique > chunk_cap:
        # a chunk's table was truncated: one rerun at a cap that fits
        add("cap-rerun", 0.0)
        return _count_minimizers_with_gc_chunked(
            sequence, k, window_size, cap, bin_size, n_chunks,
            bucket_size(max_unique, 1), device)
    if nu >= cap:
        raise ValueError(f"distinct minimizers >= cap={cap}; raise cap")
    rows = fetch_rows(acc_keys[:nu], acc_cnt[:nu], *gcs, rows=nu)
    # stitch the global-grid chunk bins (a bin cut by a boundary adds up)
    n_real = -(-total // bin_size)
    per = [int(g.numel()) for g in gcs]
    gc_glob = np.zeros(max([n_real] + [o + p for o, p in zip(offs, per)]),
                       np.int64)
    pos = 2 * nu
    for off, p in zip(offs, per):
        gc_glob[off: off + p] += rows[pos: pos + p]
        pos += p
    return (SparseEncodedCounts(KmerEncoding(sequence.encoding, k),
                                rows[:nu].view(np.uint64), rows[nu: 2 * nu]),
            gc_glob[:n_real].astype(np.int32))
