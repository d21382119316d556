"""VCF buffers: lazy INFO parsing, genotype matrices (reference:
bionumpy/io/vcf_buffers.py:78-317)."""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np

from ..bnpdataclass import BNPDataClass, make_dataclass, narrow_type, replace
from ..bnpdataclass.lazybnpdataclass import (ItemGetter, LazyBNPDataClass,
                                             create_lazy_class)
from ..datatypes import (PhasedVCFGenotypeEntry, PhasedVCFHaplotypeEntry,
                         VCFEntry, VCFEntryWithGenotypes, VCFGenotypeEntry,
                         VCFWithInfoAsStringEntry)
from ..encoded_array import EncodedArray, as_encoded_array
from ..encodings.vcf_encoding import (GenotypeRowEncoding,
                                      PhasedGenotypeRowEncoding,
                                      PhasedHaplotypeRowEncoding)
from ..ragged import RaggedArray
from ..string_array import StringArray
from .delimited_buffers import DelimitedBuffer
from .dump_csv import dump_csv
from .named_text_buffer import NamedBufferExtractor
from .vcf_header import parse_header

logger = logging.getLogger(__name__)


class InfoBuffer(DelimitedBuffer):
    """Buffer over the INFO column's KEY=value tokens; flag-typed keys
    (bool) test presence instead of parsing a value."""

    def __init__(self, buffer_extractor: NamedBufferExtractor,
                 dataclass: BNPDataClass):
        self._buffer_extractor = buffer_extractor
        self._dataclass = dataclass
        self._is_validated = True

    def _validate(self):
        pass  # token spans are pre-cut; nothing to check

    @property
    def dataclass(self):
        return self._dataclass

    def _get_field_by_number(self, col_number, field_type):
        if field_type is bool:
            return self._buffer_extractor.has_field_number(col_number)
        return super()._get_field_by_number(col_number, field_type)

    def __getitem__(self, idx):
        return type(self)(self._buffer_extractor[idx], self._dataclass)

    @classmethod
    def concatenate(cls, buffers):
        merged = buffers[0]._buffer_extractor.concatenate(
            [b._buffer_extractor for b in buffers])
        return cls(merged, buffers[0]._dataclass)


def translate_field_type(info_dict):
    """##INFO Type/Number metadata -> the python field type the record
    model coerces by (List[...] when Number allows several values)."""
    declared = info_dict.get("Type", str)
    number = info_dict.get("Number", 1)
    if number is not None and number <= 1:
        return declared
    scalar_to_list = {Optional[int]: List[int],
                      Optional[float]: List[float]}
    return scalar_to_list.get(declared, str)


def create_info_dataclass(header_data):
    if not header_data:
        return str
    header = parse_header(header_data)
    return make_dataclass(
        [(key, translate_field_type(meta))
         for key, meta in header.INFO.items() if key != "Without ID"],
        "InfoDataclass")


def _info_token_spans(text):
    """Cut each row's INFO text (trailing separator kept) into its
    ';'-separated KEY=value token spans.  Returns (flat_bytes,
    token_starts ragged, token_lengths ragged) over the raveled text —
    the gather plan NamedBufferExtractor indexes by key."""
    flat = text.ravel()
    row_bounds = np.insert(np.cumsum(text.lengths), 0, 0)
    after_semicolon = np.flatnonzero(np.asarray(flat == ";")) + 1
    cuts = np.sort(np.concatenate([after_semicolon, row_bounds]),
                   kind="mergesort")
    tokens_per_row = np.diff(np.searchsorted(cuts, row_bounds))
    starts = RaggedArray(cuts[:-1].copy(), tokens_per_row)
    lengths = RaggedArray(cuts[1:], tokens_per_row) - 1 - starts
    return flat, starts, lengths


class VCFBuffer(DelimitedBuffer):
    """VCF: position is 1-based on disk, 0-based in memory
    (reference: bionumpy/io/vcf_buffers.py:100-103)."""

    dataclass = VCFEntry
    info_cache = {}       # header text -> (info dc, lazy info dc)
    vcfentry_cache = {}   # (entry dc, header) -> (narrowed dc, lazy dc)

    # columns with bespoke parsers (INFO, genotype block); position
    # (column 1) additionally shifts 1-based disk -> 0-based memory
    _SPECIAL_COLUMNS = {7: "_get_info_field", 8: "_extract_genotypes",
                        9: "_extract_genotype_data"}
    _POSITION_COLUMN = 1

    @property
    def actual_dataclass(self):
        return self.vcf_data_class

    def _get_field_by_number(self, field_nr: int, field_type: type = object):
        special = self._SPECIAL_COLUMNS.get(field_nr)
        if special is not None:
            return getattr(self, special)()
        value = super()._get_field_by_number(field_nr, field_type)
        return value - 1 if field_nr == self._POSITION_COLUMN else value

    @classmethod
    def from_data(cls, data: BNPDataClass) -> EncodedArray:
        if isinstance(data, LazyBNPDataClass):
            data = data.get_data_object()
        data = replace(data, position=np.asarray(data.position) + 1)
        return super().from_data(data)

    @classmethod
    def process_field_for_write(cls, field_name, value):
        if field_name == "position":
            return value + 1
        return super().process_field_for_write(field_name, value)

    @classmethod
    def _info_classes_for(cls, header_data):
        """(eager, lazy) INFO dataclass pair, memoised per header text
        (generated classes are expensive; files share headers)."""
        if header_data not in cls.info_cache:
            eager = create_info_dataclass(header_data)
            lazy = None if eager is str else create_lazy_class(eager)
            cls.info_cache[header_data] = (eager, lazy)
        return cls.info_cache[header_data]

    @classmethod
    def _entry_classes_for(cls, header_data):
        """(eager, lazy) record-class pair with the info field narrowed
        to this header's INFO dataclass, memoised."""
        key = (cls.dataclass, header_data)
        if key not in cls.vcfentry_cache:
            has_info = header_data and "##INFO" in header_data
            info_class = cls._info_classes_for(header_data)[0] \
                if has_info else str
            narrowed = narrow_type(cls.dataclass, "info", info_class)
            cls.vcfentry_cache[key] = (narrowed,
                                       create_lazy_class(narrowed))
        return cls.vcfentry_cache[key]

    @property
    def info_dataclass(self):
        return self._info_classes_for(self.header_data)[0]

    @property
    def _lazy_info_class(self):
        return self._info_classes_for(self.header_data)[1]

    @property
    def vcf_data_class(self):
        return self._entry_classes_for(self.header_data)[0]

    @classmethod
    def modify_class_with_header_data(cls, header_data):
        """Specialise this buffer class to a header: the record class
        gets its info field narrowed to the header's INFO dataclass."""
        if not header_data or "##INFO" not in header_data:
            return cls
        eager, lazy = cls._entry_classes_for(header_data)
        return type(cls.__name__ + "H", (cls,),
                    {"_header_data": header_data, "dataclass": eager,
                     "lazy_class": lazy,
                     "__qualname__": cls.__qualname__ + "H"})

    def _get_info_field(self, field_nr: int = 7):
        if (not self._header_data) or ("##INFO" not in self._header_data):
            logger.warning(
                "No ##INFO in header; returning INFO field as text")
            return self._buffer_extractor.get_field_by_number(field_nr)
        return self._get_dataclass_field(field_nr, self.info_dataclass,
                                         self._lazy_info_class)

    def _get_dataclass_field(self, field_nr, dataclass, lazy_dataclass):
        """A KEY=value column as a lazy dataclass: cut token spans, wrap
        them in a named extractor, and hand the InfoBuffer to the lazy
        class so individual keys parse on attribute access."""
        column_text = self._buffer_extractor.get_field_by_number(
            field_nr, keep_sep=True)
        flat, starts, lengths = _info_token_spans(column_text)
        extractor = NamedBufferExtractor(
            flat, starts, lengths,
            [f.name for f in dataclasses.fields(dataclass)])
        return lazy_dataclass(
            ItemGetter(InfoBuffer(extractor, dataclass), dataclass))

    def _extract_genotypes(self):
        if self._buffer_extractor.n_fields < 10:
            return StringArray(
                np.empty((len(self._buffer_extractor), 0), dtype="S1"))
        byte_array = self._buffer_extractor.get_padded_field(
            slice(9, None), stop_at=":").raw()
        n_bytes = byte_array.shape[-1]
        if n_bytes == 0:
            out = np.empty(
                (len(self._buffer_extractor),
                 self._buffer_extractor.n_fields - 9), dtype="S1")
        else:
            out = np.ascontiguousarray(byte_array).view(
                f"S{n_bytes}").reshape(byte_array.shape[:-1])
        return StringArray(out)

    def _extract_genotype_data(self):
        return None

    def get_column_range_as_text(self, col_start, col_end, keep_sep=False):
        if col_start != 8:
            return super().get_column_range_as_text(col_start, col_end,
                                                    keep_sep=keep_sep)
        return self._buffer_extractor.get_fields_by_range(from_nr=8,
                                                          to_nr=None,
                                                          keep_sep=keep_sep)

    @classmethod
    def make_header(cls, data) -> bytes:
        header = ""
        if data.has_context("header") and data.get_context("header"):
            header = data.get_context("header")
        else:
            header = "\n".join([
                "##fileformat=VCFv4.1",
                "\t".join("#CHROM POS ID REF ALT QUAL FILTER INFO "
                          "FORMAT".split())]) + "\n"
        return bytes(header, "ascii")


class VCFBuffer2(VCFBuffer):
    dataclass = VCFEntryWithGenotypes

    @classmethod
    def from_data(cls, data: BNPDataClass) -> EncodedArray:
        if isinstance(data, LazyBNPDataClass):
            return cls.from_data(data.get_data_object())
        data = replace(data, position=np.asarray(data.position) + 1)
        data_dict = [(field.type, getattr(data, field.name))
                     for field in dataclasses.fields(data)]
        data_dict = data_dict[:-1] + \
            [(str, as_encoded_array(["GT"] * len(data)))] + [data_dict[-1]]
        return dump_csv(data_dict, cls.DELIMITER)


class VCFWithInfoAsStringBuffer(VCFBuffer):
    dataclass = VCFWithInfoAsStringEntry


class VCFMatrixBuffer(VCFBuffer):
    dataclass = VCFGenotypeEntry
    genotype_encoding = GenotypeRowEncoding

    def _get_field_by_number(self, field_nr: int, field_type: type = object):
        if field_nr != 8:
            assert field_nr < 8, (field_nr, field_type)
            return super()._get_field_by_number(field_nr, field_type)
        genotype_data = self._buffer_extractor.get_fixed_length_field(
            slice(9, None), 3)
        return EncodedArray(self.genotype_encoding.encode(genotype_data),
                            self.genotype_encoding)


class PhasedVCFMatrixBuffer(VCFMatrixBuffer):
    dataclass = PhasedVCFGenotypeEntry
    genotype_encoding = PhasedGenotypeRowEncoding


class PhasedHaplotypeVCFMatrixBuffer(VCFMatrixBuffer):
    dataclass = PhasedVCFHaplotypeEntry
    genotype_encoding = PhasedHaplotypeRowEncoding


class VCFHaplotypeBuffer(VCFBuffer2):
    """Alias buffer reading genotype columns as raw strings
    (reference: bionumpy/io/vcf_buffers.py:316-317)."""
