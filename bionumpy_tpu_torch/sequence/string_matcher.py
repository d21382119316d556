"""Exact / wildcard / regex matching over sequence sets
(reference: bionumpy/sequence/string_matcher.py; the port's copy of
bionumpy_tpu/sequence/string_matcher.py)."""
from __future__ import annotations

import itertools
import logging
import re

import numpy as np

from ..encoded_array import (EncodedArray, Encoding, as_encoded_array)
from ..encodings.alphabet_encoding import AlphabetEncoding
from ..ragged import RaggedArray, RaggedShape
from .rollable import RollableFunction

logger = logging.getLogger(__name__)


def match_string(sequence, matching_sequence) -> RaggedArray:
    """Boolean positions where `matching_sequence` occurs in each row.

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> from bionumpy_tpu_torch.sequence import match_string
    >>> match_string(bnp.as_encoded_array(["ACGTAC"]), "AC")
    ragged_array([[True, False, False, False, True]])
    """
    sequence = as_encoded_array(sequence)
    encoding = sequence.encoding
    matching_sequence = as_encoded_array(matching_sequence, encoding)
    return StringMatcher(matching_sequence,
                         encoding).rolling_window(sequence)


class StringMatcher(RollableFunction):
    def __init__(self, matching_sequence, encoding: Encoding):
        self._encoding = encoding
        self._matching_sequence_array = as_encoded_array(
            matching_sequence, target_encoding=encoding)

    @property
    def window_size(self) -> int:
        return len(self._matching_sequence_array)

    def __call__(self, sequence):
        return np.all(np.asarray(sequence == self._matching_sequence_array),
                      axis=-1)


class MaskedStringMatcher(RollableFunction):
    def __init__(self, matching_sequence_array, mask):
        assert isinstance(mask, np.ndarray)
        assert matching_sequence_array.shape == mask.shape
        self._matching_sequence_array = matching_sequence_array
        self._mask = mask

    @property
    def window_size(self) -> int:
        return len(self._matching_sequence_array)

    def __call__(self, sequence):
        direct_match = np.asarray(sequence == self._matching_sequence_array)
        return np.all(np.logical_or(direct_match, self._mask), axis=-1)


class FixedLenRegexMatcher(RollableFunction):
    def __init__(self, matching_regex: str, encoding):
        self._sub_matchers = construct_fixed_len_regex_matchers(
            matching_regex, encoding)
        self._encoding = encoding

    @property
    def window_size(self) -> int:
        return self._sub_matchers[0].window_size

    def __call__(self, sequence):
        union = self._sub_matchers[0](sequence)
        for matcher in self._sub_matchers[1:]:
            union = np.logical_or(union, matcher(sequence))
        return union


class RegexMatcher(RollableFunction):
    """Length-flexible regex: `.{m,n}` gaps expand to a set of fixed-length
    matchers OR-ed in mode='same'."""

    def __init__(self, matching_regex: str, encoding):
        self._sub_matchers = construct_flexible_len_regex_matchers(
            matching_regex, encoding)
        self._encoding = encoding

    def __call__(self, sequence):
        raise NotImplementedError

    @property
    def window_size(self):
        return [m.window_size for m in self._sub_matchers]

    def rolling_window(self, _sequence, window_size=None, mode="same"):
        if mode == "valid":
            logger.warning("RegexMatcher always uses mode='same'")
        _sequence = as_encoded_array(_sequence, self._encoding)
        is_ragged = not isinstance(_sequence, EncodedArray)
        out = None
        for sub_matcher in self._sub_matchers:
            matched = sub_matcher.rolling_window(_sequence, mode="same")
            matched_flat = matched.ravel() if is_ragged else matched
            out = matched_flat if out is None else \
                np.logical_or(out, matched_flat)
        if is_ragged:
            return RaggedArray(np.asarray(out),
                               RaggedShape(_sequence.lengths))
        return out


def construct_fixed_len_regex_matchers(matching_regex: str, encoding):
    char_class = re.compile(r"\[[^\]]+\]")
    hit = char_class.search(matching_regex)
    if hit is None:
        return [construct_wildcard_matcher(matching_regex, encoding)]
    start, end = hit.span()
    pre, post = matching_regex[:start], matching_regex[end:]
    return list(itertools.chain.from_iterable(
        construct_fixed_len_regex_matchers(pre + symbol + post, encoding)
        for symbol in matching_regex[start + 1: end - 1]))


def construct_flexible_len_regex_matchers(matching_regex: str, encoding):
    flexible = re.compile(
        r"(([A-Z]|\[[A-Z]+\])+)\.\{(\d*)\,(\d+)\}(.+)")
    hit = flexible.search(matching_regex)
    if hit is None:
        return construct_fixed_len_regex_matchers(matching_regex, encoding)
    min_gap = int(hit.group(3)) if hit.group(3) != "" else 0
    max_gap = int(hit.group(4))
    pre = matching_regex[: hit.end(1)]
    post = matching_regex[hit.start(5):]
    return list(itertools.chain.from_iterable(
        construct_flexible_len_regex_matchers(pre + "." * n + post, encoding)
        for n in range(min_gap, max_gap + 1)))


def construct_wildcard_matcher(matching_regex: str, encoding):
    assert isinstance(encoding, AlphabetEncoding)
    mask = np.array([symbol == "." for symbol in matching_regex])
    replacement = encoding.get_alphabet()[0]
    base_seq = as_encoded_array(matching_regex.replace(".", replacement),
                                target_encoding=encoding)
    return MaskedStringMatcher(base_seq, mask)
