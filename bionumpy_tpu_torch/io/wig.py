"""Wiggle/bedgraph-with-comments buffer (reference: bionumpy/io/wig.py)."""
from ..datatypes import BedGraph
from .delimited_buffers import DelimitedBufferWithInernalComments


class WigBuffer(DelimitedBufferWithInernalComments):
    dataclass = BedGraph
    DELIMITER = "\t"
