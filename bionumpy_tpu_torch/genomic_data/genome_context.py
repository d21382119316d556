"""Genome context: ordered chromosome sizes + name encoding (reference:
bionumpy/genomic_data/genome_context.py:26-135; the port's copy of
bionumpy_tpu/genomic_data/genome_context.py)."""
from __future__ import annotations

import logging
from typing import Dict, Iterable

import numpy as np

from ..bnpdataclass import replace
from ..encoded_array import as_encoded_array
from ..encodings.string_encodings import StringEncoding
from ..streams import groupby
from .global_offset import GlobalOffset

logger = logging.getLogger(__name__)


class GenomeError(Exception):
    pass


def ignore_underscores(name: str) -> bool:
    return "_" not in name


def keep_all(name: str) -> bool:
    return True


class GenomeContext:
    def __init__(self, chrom_size_dict: Dict[str, int], ignored=None):
        self._original_chrom_sizes = chrom_size_dict
        self._ignored = set(ignored) if ignored is not None else set()
        keys = [name for name in chrom_size_dict
                if name not in self._ignored] + list(self._ignored)
        ordered = {key: chrom_size_dict[key] for key in keys}
        self._included = [c for c in ordered if c not in self._ignored]
        self._included_mask = np.array(
            [c in self._included for c in ordered])
        self._string_encoding = StringEncoding(list(ordered.keys()))
        self._chrom_size_dict = {k: v for k, v in ordered.items()
                                 if k in self._included}
        self._global_offset = GlobalOffset(
            self._chrom_size_dict, string_encoding=self._string_encoding)

    @classmethod
    def from_dict(cls, chrom_size_dict,
                  filter_function=ignore_underscores) -> "GenomeContext":
        if filter_function is None:
            filter_function = keep_all
        ignored_keys = {key for key in chrom_size_dict
                        if not filter_function(key)}
        if ignored_keys:
            logger.info("Ignoring %d chromosomes by filter %s",
                        len(ignored_keys), filter_function.__name__)
        return cls(chrom_size_dict, ignored_keys)

    def with_ignored_added(self, ignored: Iterable[str]) -> "GenomeContext":
        c = dict(self._original_chrom_sizes)
        c.update({name: 0 for name in ignored})
        return self.__class__(c, set(ignored) | self._ignored)

    def __repr__(self):
        return repr(list(self._included)[:10] +
                    ["..."] * (len(self._included) > 10))

    @property
    def size(self) -> int:
        return sum(self._chrom_size_dict.values())

    @property
    def encoding(self) -> StringEncoding:
        return self._string_encoding

    @property
    def chrom_sizes(self) -> Dict[str, int]:
        return self._chrom_size_dict

    @property
    def global_offset(self) -> GlobalOffset:
        return self._global_offset

    def is_included(self, chromosomes) -> np.ndarray:
        return self._included_mask[chromosomes.raw()]

    def mask_data(self, data, chromosome_field_name: str = "chromosome"):
        """Encode the chromosome field + drop entries on ignored
        chromosomes."""
        encoded = as_encoded_array(getattr(data, chromosome_field_name),
                                   self.encoding)
        data = replace(data, **{chromosome_field_name: encoded})
        if np.all(self._included_mask):
            return data
        mask = self.is_included(encoded)
        if np.all(mask):
            return data
        return data[mask]

    def chromosome_order(self):
        return (key for key in self._chrom_size_dict if "_" not in key)

    def is_compatible(self, other) -> bool:
        return (self._chrom_size_dict == other._chrom_size_dict and
                self._included == other._included)

    def _included_groups(self, grouped):
        for name, group in grouped:
            if name in self._ignored:
                continue
            if name not in self._included:
                raise GenomeError(
                    f"{name} not included in genome: "
                    f"{set(self._chrom_size_dict.keys())}")
            yield name, group

    def iter_chromosomes(self, data, dataclass,
                         group_field: str = "chromosome"):
        """Yield per-chromosome groups in genome order, filling empty for
        missing contigs and raising on sort-order discrepancies."""
        real_order = self.chromosome_order()
        grouped = self._included_groups(groupby(data, group_field))
        next_name, next_group = next(grouped, (None, None))
        seen = []
        for name in real_order:
            if name == next_name:
                yield next_group
                next_name, next_group = next(grouped, (None, None))
                if next_name in seen:
                    raise GenomeError(
                        f"Sort order discrepancy ({next_name}); seen "
                        f"{seen}")
            else:
                yield dataclass.empty()
            seen.append(name)
        if next_name is not None:
            raise GenomeError(
                f"Data for {next_name} after end of genome order")
