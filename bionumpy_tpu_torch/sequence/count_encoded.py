"""Label-space counting (the port's copy of
bionumpy_tpu/sequence/count_encoded.py).

The axis=-1 per-row count avoids the reference's per-row Python
bincount loop (count_encoded.py:176) by one flat bincount over
row_index * n_labels + value.
"""
from __future__ import annotations

from numbers import Number
from typing import Dict, List, Optional

import numpy as np

from ..encoded_array import EncodedArray, EncodedRaggedArray
from ..io.matrix_dump import Matrix
from ..ragged import RaggedArray


def _same_labels(a, b) -> bool:
    """Label sequences compare by their items, so a range of label codes
    (the port's dense k-mer counts for k > 8) equals the list of the same
    ints that the JAX package builds; two ranges compare without
    materializing either."""
    if isinstance(a, range) and isinstance(b, range):
        return a == b
    if isinstance(a, range) or isinstance(b, range):
        return len(a) == len(b) and list(a) == list(b)
    return a == b


class EncodedCounts:
    def __init__(self, alphabet, counts, row_names=None):
        self.alphabet = alphabet
        self.counts = counts
        self.row_names = row_names

    def __str__(self):
        return "\n".join(f"{c}: {n}"
                         for c, n in zip(self.alphabet, self.counts.T))

    def __repr__(self):
        return (f"EncodedCounts(alphabet={self.alphabet!r}, "
                f"counts={self.counts!r}, row_names={self.row_names!r})")

    def __eq__(self, other):
        if not _same_labels(self.alphabet, other.alphabet):
            return False
        return bool(np.all(self.counts == other.counts))

    def __getitem__(self, idx: str):
        return self.counts[..., self.alphabet.index(idx)]

    def _other_counts(self, other):
        if isinstance(other, Number):
            return other
        assert _same_labels(self.alphabet, other.alphabet)
        return other.counts

    def __add__(self, other):
        return self.__class__(self.alphabet,
                              self.counts + self._other_counts(other))

    __radd__ = __add__

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__":
            return NotImplemented
        arrays = [i.counts if isinstance(i, EncodedCounts) else i
                  for i in inputs]
        kwargs = {k: i.counts if isinstance(i, EncodedCounts) else i
                  for k, i in kwargs.items()}
        return self.__class__(self.alphabet, ufunc(*arrays, **kwargs))

    @property
    def proportions(self) -> np.ndarray:
        s = self.counts.sum(axis=-1, keepdims=True)
        return np.where(s > 0, self.counts / s, 0)

    @property
    def proportion_matrix(self) -> Matrix:
        return Matrix(self.proportions, col_names=self.alphabet)

    def get_count_for_label(self, label: str) -> int:
        return sum(np.sum(self.counts[..., self.alphabet.index(c)])
                   for c in label)

    @property
    def labels(self) -> List[str]:
        return self.alphabet

    @classmethod
    def vstack(cls, counts):
        alphabet = counts[0].alphabet
        assert all(_same_labels(c.alphabet, alphabet) for c in counts)
        ret = cls(alphabet,
                  np.array([c.counts for c in counts], dtype="int"))
        if counts[0].row_names is not None:
            ret.row_names = [c.row_names for c in counts]
        return ret

    def most_common(self, n: Optional[int] = None) -> "EncodedCounts":
        args = np.argsort(self.counts)[::-1]
        if n is not None:
            args = args[:n]
        return self.__class__([self.alphabet[i] for i in args],
                              self.counts[args])

    def as_dict(self) -> Dict[str, np.ndarray]:
        return dict(zip(self.alphabet, self.counts.T))


class SparseEncodedCounts(EncodedCounts):
    """Counts over only the OBSERVED labels of a label space too large to
    enumerate (e.g. 31-mers: 4^31 labels).  Keyed by integer label codes
    (k-mer hashes); label strings materialize lazily.

    The reference cannot count such spaces at all (np.bincount with
    minlength=4**k, bionumpy/sequence/count_encoded.py:168-173, and
    get_labels is k<=8-only); here the card sorts and compacts the int64
    window keys and the host keeps a sorted (hash, count) table.
    Addition merges tables, so chunk partials fold associatively."""

    def __init__(self, encoding, label_codes, counts, row_names=None):
        self.encoding = encoding
        self.label_codes = np.asarray(label_codes, dtype=np.uint64)
        self.counts = np.asarray(counts)
        self.row_names = row_names

    @property
    def alphabet(self) -> List[str]:
        return [self.encoding.to_string(int(h)) for h in self.label_codes]

    def __repr__(self):
        return (f"SparseEncodedCounts({self.encoding}, "
                f"n_observed={len(self.label_codes)}, "
                f"total={int(self.counts.sum())})")

    def __eq__(self, other):
        return (isinstance(other, SparseEncodedCounts) and
                self.encoding == other.encoding and
                np.array_equal(self.label_codes, other.label_codes) and
                np.array_equal(self.counts, other.counts))

    def __getitem__(self, idx: str):
        code = np.uint64(int(np.asarray(self.encoding.encode(idx).raw())))
        pos = int(np.searchsorted(self.label_codes, code))
        if pos < len(self.label_codes) and self.label_codes[pos] == code:
            return self.counts[pos]
        return self.counts.dtype.type(0)

    def __add__(self, other):
        if isinstance(other, Number):
            if other != 0:
                raise ValueError("can only fold with the identity 0")
            return self
        if not isinstance(other, SparseEncodedCounts) or \
                self.encoding != other.encoding:
            raise TypeError(f"cannot add {other!r} to {self!r}")
        # both tables are sorted by hash: O(n) searchsorted merge beats
        # np.unique (full re-sort) ~3x on the stream-fold hot path
        uniq, merged = merge_sorted_tables(
            self.label_codes, self.counts,
            other.label_codes, other.counts)
        return self.__class__(self.encoding, uniq, merged)

    __radd__ = __add__

    def most_common(self, n: Optional[int] = None) -> EncodedCounts:
        args = np.argsort(self.counts, kind="stable")[::-1]
        if n is not None:
            args = args[:n]
        return EncodedCounts(
            [self.encoding.to_string(int(self.label_codes[i]))
             for i in args], self.counts[args])

    def as_dict(self) -> Dict[str, np.ndarray]:
        return dict(zip(self.alphabet, self.counts))

    @classmethod
    def from_hashes(cls, encoding,
                    hashes: np.ndarray) -> "SparseEncodedCounts":
        uniq, counts = np.unique(np.asarray(hashes, dtype=np.uint64),
                                 return_counts=True)
        return cls(encoding, uniq, counts.astype(np.int64))


def count_encoded(values, weights=None, axis: int = -1) -> EncodedCounts:
    """Count occurrences of encoded labels (reference semantics:
    bionumpy/sequence/count_encoded.py:150-188).

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> bnp.count_encoded(bnp.as_encoded_array(["ACGG"], bnp.DNAEncoding))
    EncodedCounts(alphabet=['A', 'C', 'G', 'T'], counts=array([[1, 1, 2, 0]]), row_names=None)
    """
    weights2d = weights is not None and np.asarray(weights).ndim == 2
    if axis is None:
        values = values.ravel()
    encoding = values.encoding
    if hasattr(encoding, "get_alphabet"):
        alphabet = encoding.get_alphabet()
    elif getattr(encoding, "k", 0) > 8:
        # label space too large to enumerate (e.g. 31-mers): count only
        # the observed labels
        assert axis is None and weights is None, \
            "large label spaces support only axis=None unweighted counts"
        return SparseEncodedCounts.from_hashes(
            encoding, np.asarray(values.raw()).astype(np.uint64))
    else:
        alphabet = encoding.get_labels()
    n_labels = len(alphabet)
    if isinstance(values, EncodedArray) and values.ndim == 1 and not weights2d:
        counts = np.bincount(values.raw(), weights=weights,
                             minlength=n_labels)
        if weights is None:
            counts = counts.astype(np.int64)
    elif axis == -1:
        if isinstance(values, EncodedRaggedArray) and not weights2d:
            # one flat bincount over row*n_labels+value
            flat = np.asarray(values.ravel().raw()).astype(np.int64)
            rows = np.repeat(np.arange(len(values)), values.lengths)
            combined = rows * n_labels + flat
            w = None if weights is None else np.asarray(
                weights.ravel() if isinstance(weights, RaggedArray)
                else weights)
            counts = np.bincount(combined, weights=w,
                                 minlength=len(values) * n_labels
                                 ).reshape(len(values), n_labels)
            if weights is None:
                counts = counts.astype(np.int64)
        elif weights2d:
            counts = np.array(
                [np.bincount(values.raw(), weights=row, minlength=n_labels)
                 for row in np.asarray(weights)])
            if not np.issubdtype(np.asarray(weights).dtype, np.floating):
                counts = counts.astype(int)
        else:
            counts = np.array(
                [np.bincount(np.asarray(row.raw() if hasattr(row, "raw")
                                        else row), weights=weights,
                             minlength=n_labels)
                 for row in values])
    else:
        raise ValueError(f"unsupported axis {axis}")
    return EncodedCounts(alphabet, counts)


def merge_sorted_tables(h1, c1, h2, c2):
    """Merge two SORTED (hash, count) tables, summing equal keys — O(n)
    numpy passes (an argsort of the concatenation costs ~3x more; this
    is the associative fold of the reference's stream reductions,
    bionumpy/streams/reductions.py:6-23)."""
    if len(h1) == 0:
        return h2, c2
    if len(h2) == 0:
        return h1, c1
    pos2 = np.searchsorted(h1, h2, side="right") + \
        np.arange(len(h2), dtype=np.int64)
    n = len(h1) + len(h2)
    out_h = np.empty(n, h1.dtype)
    out_c = np.empty(n, np.int64)
    mask1 = np.ones(n, bool)
    mask1[pos2] = False
    out_h[pos2] = h2
    out_c[pos2] = c2
    out_h[mask1] = h1
    out_c[mask1] = c1
    keep = np.empty(n, bool)
    keep[0] = True
    np.not_equal(out_h[1:], out_h[:-1], out=keep[1:])
    idx = np.flatnonzero(keep)
    return out_h[idx], np.add.reduceat(out_c, idx)
