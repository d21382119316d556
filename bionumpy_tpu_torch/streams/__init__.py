"""Chunk streams (the part of bionumpy_tpu/streams the port needs so far:
BnpStream and its subclasses, and the @streamable decorator).  The rest of
the JAX package's streams/ is ROADMAP queue 1 work."""
from .stream import (ArrayStream, BnpStream, ChunkStream, NpDataclassStream,
                     grouped_dict, grouped_stream)
from .decorators import streamable

__all__ = ["BnpStream", "NpDataclassStream", "ArrayStream", "ChunkStream",
           "streamable", "grouped_stream", "grouped_dict"]
