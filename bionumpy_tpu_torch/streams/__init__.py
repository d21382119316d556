"""Chunk streams: typed iterators over record-batch chunks, the
@streamable decorator, the associative reductions, grouping and the
chromosome-synchronised MultiStream (the port's copy of
bionumpy_tpu/streams/)."""
from .stream import (ArrayStream, BnpStream, ChunkStream, NpDataclassStream,
                     grouped_dict, grouped_stream)
from .decorators import streamable
from .reductions import bincount, histogram, mean, quantile
from .groupby_func import groupby
from .multistream import (IndexedStream, MultiStream, SequenceSizes,
                          StreamError, SynchedStream)
from .chunk_entries import chunk_entries
from .grouped import chromosome_map
from .left_join import left_join

__all__ = ["BnpStream", "NpDataclassStream", "ArrayStream", "ChunkStream",
           "streamable", "mean", "bincount", "histogram", "quantile",
           "groupby", "MultiStream", "SynchedStream", "IndexedStream",
           "SequenceSizes", "StreamError", "chunk_entries", "left_join",
           "grouped_stream", "grouped_dict", "chromosome_map"]
