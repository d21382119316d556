"""pairtools .pairs buffer (reference: bionumpy/io/pairs.py)."""
from ..datatypes import PairsEntry
from .delimited_buffers import DelimitedBuffer


class PairsBuffer(DelimitedBuffer):
    dataclass = PairsEntry
