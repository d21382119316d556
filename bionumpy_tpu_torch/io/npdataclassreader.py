"""Main user-facing reader (reference:
bionumpy/io/npdataclassreader.py:14-142)."""
from __future__ import annotations

from itertools import repeat, takewhile
from typing import Optional

from .. import config
from ..bnpdataclass import BNPDataClass
from ..bnpdataclass.lazybnpdataclass import ItemGetter, create_lazy_class
from ..streams import NpDataclassStream
from .exceptions import FormatException
from .parser import NumpyFileReader


class NpDataclassReader:
    def __init__(self, numpyfilereader: NumpyFileReader, lazy=None):
        self._reader = numpyfilereader
        self.__lazy_class = None
        self._lazy = lazy

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self._reader.close()

    def close(self):
        self._reader.close()

    def read(self) -> BNPDataClass:
        chunk = self._reader.read()
        if chunk is None:
            return self._reader.buffer_type.dataclass.empty()
        if self._should_be_lazy(chunk):
            return self._get_lazy_class(chunk.dataclass, chunk.header_data)(
                ItemGetter(chunk, chunk.dataclass))
        return chunk.get_data()

    def read_chunk(self, min_chunk_size: int = 5_000_000,
                   max_chunk_size: int = None) -> BNPDataClass:
        n_lines_read = self._reader.n_lines_read
        chunk = self._reader.read_chunk(min_chunk_size, max_chunk_size)
        if chunk is None:
            return self._reader.buffer_type.dataclass.empty()
        try:
            if self._should_be_lazy(chunk):
                return self._get_lazy_class(
                    chunk.dataclass, header=chunk.header_data)(
                    ItemGetter(chunk, chunk.dataclass, n_lines_read))
            return chunk.get_data()
        except FormatException as e:
            e.line_number += n_lines_read
            raise e

    def read_chunks(self, min_chunk_size: int = 5_000_000,
                    max_chunk_size: Optional[int] = None) -> NpDataclassStream:
        data_stream = takewhile(
            len, (self.read_chunk(min_chunk_size, max_chunk_size)
                  for _ in repeat(None)))
        return NpDataclassStream(data_stream,
                                 dataclass=self._reader.buffer_type.dataclass)

    def __iter__(self) -> NpDataclassStream:
        return self.read_chunks()

    def _get_lazy_class(self, dataclass, header=None):
        if self.__lazy_class is None:
            self.__lazy_class = create_lazy_class(dataclass, header=header)
        return self.__lazy_class

    def _should_be_lazy(self, chunk) -> bool:
        from ..datatypes import GTFEntry
        if ((not config.LAZY) and self._lazy is None) or self._lazy is False:
            return False
        if getattr(chunk, "SKIP_LAZY", False):
            return False
        if hasattr(chunk, "get_field_by_number") and \
                hasattr(chunk, "dataclass"):
            if not issubclass(chunk.dataclass, GTFEntry):
                return True
        return False
