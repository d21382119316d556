"""Chunk streams: thin typed iterators over record-batch chunks (the
port's copy of bionumpy_tpu/streams/stream.py).

Semantics match the reference's stream wrappers — iterating yields chunks, attribute
access on a dataclass stream yields a stream of that field per chunk —
but the implementation buffers lazily: nothing is pulled from the
underlying source until the stream is iterated or explicitly peeked,
so constructing a stream never triggers file IO or device work.
"""
from __future__ import annotations

_NOTHING = object()


class BnpStream:
    """Iterator over chunks with an on-demand single-chunk peek."""

    def __init__(self, chunks):
        self._chunks = iter(chunks)
        self._buffered = _NOTHING
        self._consumed_any = False

    def __iter__(self):
        return self

    def __next__(self):
        self._consumed_any = True
        if self._buffered is not _NOTHING:
            chunk, self._buffered = self._buffered, _NOTHING
            return chunk
        return next(self._chunks)

    def peek(self, default=None):
        """Look at the next chunk without consuming it."""
        if self._buffered is _NOTHING:
            self._buffered = next(self._chunks, _NOTHING)
        return default if self._buffered is _NOTHING else self._buffered

    @property
    def is_opened(self) -> bool:
        return self._consumed_any

    def __str__(self):
        state = "opened" if self._consumed_any else "unopened"
        return (f"{state.capitalize()} stream of data buffers. "
                f"Next buffer:\n{self.peek()}")

    def __repr__(self):
        return f"{type(self).__name__}(<{type(self._chunks).__name__}>)"


class ChunkStream(BnpStream):
    pass


class ArrayStream(ChunkStream):
    pass


class NpDataclassStream(BnpStream):
    """Stream of record batches; accessing a field name returns the
    per-chunk stream of that field's arrays."""

    def __init__(self, chunks, dataclass=None):
        super().__init__(chunks)
        self.dataclass = dataclass

    def _field_chunks(self, name):
        for chunk in self:
            yield getattr(chunk, name)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ArrayStream(self._field_chunks(name))


def grouped_dict(attribute_name=None):
    def decorator(base_class):
        base_class.grouped_dict_attribute = attribute_name
        return base_class
    return decorator


class grouped_stream(BnpStream):
    """Stream of (group_key, data) pairs (reference:
    bionumpy/streams/grouped.py:14-18)."""

    def __init__(self, chunks, attribute_name=None):
        self.attribute_name = attribute_name
        super().__init__(chunks)
