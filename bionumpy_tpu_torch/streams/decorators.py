"""@streamable: lift a per-chunk function over chunk streams.

Semantics follow the reference decorator (reference:
bionumpy/streams/decorators.py:9-110): when any positional argument is
a chunk stream or generator, the function is applied chunk-wise with
the streamed slots substituted in lock-step; an optional `reduction`
folds the per-chunk results.  Every reduction used with it in this
package is associative.  (The port's copy of
bionumpy_tpu/streams/decorators.py.)
"""
from __future__ import annotations

import functools
import types

from .stream import BnpStream

_STREAM_TYPES = (BnpStream, types.GeneratorType)


class streamable:
    """Decorator factory.

    >>> @streamable(sum)
    ... def total(x):
    ...     return int(x.sum())
    >>> import numpy as np
    >>> total(np.arange(5))
    10
    >>> total(BnpStream(iter([np.arange(5), np.arange(3)])))
    13
    """

    def __init__(self, reduction: callable = None):
        self._reduction = reduction

    def __call__(self, func: callable) -> callable:
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            streamed_slots = {index: value
                              for index, value in enumerate(args)
                              if isinstance(value, _STREAM_TYPES)}
            if not streamed_slots:
                return func(*args, **kwargs)

            def chunk_results():
                call_args = list(args)
                for chunks in zip(*streamed_slots.values()):
                    for slot, chunk in zip(streamed_slots, chunks):
                        call_args[slot] = chunk
                    yield func(*call_args, **kwargs)

            if self._reduction is not None:
                return self._reduction(chunk_results())
            return BnpStream(chunk_results())

        return wrapper
