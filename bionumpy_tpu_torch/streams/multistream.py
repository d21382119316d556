"""Chromosome-synchronized multi-source streams (the port's copy of
bionumpy_tpu/streams/multistream.py).

Semantics follow the reference MultiStream/SynchedStream (reference:
bionumpy/streams/multistream.py:36-218): several streams or dict-like
sources are aligned on one contig order, missing contigs are filled
with an empty default, and sort-order violations raise StreamError.
The synchronisation here is index-based: each incoming group is mapped
to its position in the contig order and gaps are filled by range, so
ordering violations are detected by a single monotonicity check.
"""
from __future__ import annotations

import logging

import numpy as np

from ..bnpdataclass import BNPDataClass
from .groupby_func import groupby
from .stream import BnpStream, NpDataclassStream

logger = logging.getLogger(__name__)


class StreamError(Exception):
    pass


class SequenceSizes(dict):
    pass


def human_key_func(chrom_name: str):
    """Sort key giving the human-friendly chr1 < chr2 < ... < chrX
    ordering, underscore-suffixed scaffolds last per number."""
    assert chrom_name.startswith("chr"), chrom_name
    body, _, suffix = chrom_name[3:].partition("_")
    if body.isdigit():
        return (0, int(body), suffix)
    return (1, body, suffix)


def sort_dict_by_key(dictionary, key=None):
    return {name: dictionary[name]
            for name in sorted(dictionary, key=key)}


class SynchedStream(BnpStream):
    """Group a stream by a field (default "chromosome") and emit one
    group per contig in `contig_order`, empty-filling missing ones."""

    def __init__(self, stream, contig_order):
        self._stream = stream
        self._contig_order = list(contig_order)
        self._grouping_attribute = "chromosome"
        self._has_default = True
        dataclass = getattr(stream, "dataclass", None)
        self._default_value = dataclass.empty() \
            if dataclass is not None else None
        self._key_func = lambda name: name

    def set_grouping_attribute(self, attribute_name):
        """Group by a different field than \"chromosome\"."""
        self._grouping_attribute = attribute_name

    def set_key_function(self, key_function):
        """Map incoming group names before contig-order lookup."""
        self._key_func = key_function

    def set_default(self, default_value):
        """Value yielded for contigs the stream has no data for."""
        self._has_default = True
        self._default_value = default_value

    def _fill_value(self, contig):
        if not self._has_default:
            raise StreamError(
                f"no data for contig {contig} and no default value set")
        logger.info("filling empty data for missing contig %s", contig)
        return self._default_value

    def __iter__(self):
        position = {name: i for i, name in enumerate(self._contig_order)}
        last_emitted = -1
        for raw_name, data in groupby(self._stream,
                                      self._grouping_attribute):
            name = self._key_func(raw_name)
            target = position.get(name)
            if target is None:
                raise StreamError(
                    f"stream contig {name!r} is not in the contig "
                    f"order {self._contig_order}")
            if target <= last_emitted:
                raise StreamError(
                    f"sort-order discrepancy: {name!r} arrived after "
                    f"{self._contig_order[last_emitted]!r} (stream must "
                    f"follow the contig order)")
            for gap in range(last_emitted + 1, target):
                yield self._fill_value(self._contig_order[gap])
            yield data
            last_emitted = target
        for gap in range(last_emitted + 1, len(self._contig_order)):
            yield self._fill_value(self._contig_order[gap])

    def __repr__(self):
        return f"SynchedStream over {self._contig_order}"

    __str__ = __repr__


class IndexedStream(BnpStream):
    """Stream the values of a dict-like source in contig order."""

    def __init__(self, lookup, contig_order):
        self._lookup = lookup
        self._contig_order = list(contig_order)

    def __iter__(self):
        return (self._lookup[name] for name in self._contig_order)

    def __repr__(self):
        return f"IndexedStream over contigs: {self._contig_order}"

    __str__ = __repr__


class MultiStream:
    """Synchronize several streams/dicts on one chromosome order; each
    keyword source becomes an attribute yielding per-contig data."""

    def __init__(self, sequence_sizes, **sources):
        names, lengths = self._names_and_lengths(sequence_sizes)
        self._sequence_names = names
        self.lengths = BnpStream(lengths)
        self.sequence_names = BnpStream(names)
        for keyword, value in sources.items():
            self.__dict__[keyword] = self._synchronize(keyword, value,
                                                       names)

    @staticmethod
    def _names_and_lengths(sequence_sizes):
        from ..datatypes import ChromosomeSize
        if isinstance(sequence_sizes, dict):
            return (list(sequence_sizes.keys()),
                    list(sequence_sizes.values()))
        if isinstance(sequence_sizes, ChromosomeSize):
            return (sequence_sizes.name.tolist(),
                    np.asarray(sequence_sizes.size).tolist())
        raise TypeError("MultiStream needs a dict or ChromosomeSize, "
                        f"got {type(sequence_sizes)}")

    @staticmethod
    def _synchronize(keyword, value, names):
        if isinstance(value, BNPDataClass):
            value = NpDataclassStream([value], value.__class__)
        if isinstance(value, BnpStream):
            return SynchedStream(value, names)
        if hasattr(value, "__getitem__"):
            return IndexedStream(value, names)
        raise ValueError(
            f"only streams and dict-likes supported: {keyword}")

    def _configure(self, method_name, settings):
        for keyword, value in settings.items():
            assert keyword in self.__dict__, keyword
            getattr(self.__dict__[keyword], method_name)(value)

    def set_defaults(self, **kwargs):
        self._configure("set_default", kwargs)

    def set_key_functions(self, **kwargs):
        self._configure("set_key_function", kwargs)

    human_key_func = staticmethod(human_key_func)
    sort_dict_by_key = staticmethod(sort_dict_by_key)
