"""Legacy per-chromosome function mapping decorator (reference:
bionumpy/streams/grouped.py:22-111; the port's copy of
bionumpy_tpu/streams/grouped.py)."""
from __future__ import annotations

import logging

from .stream import grouped_dict, grouped_stream

logger = logging.getLogger(__name__)


class chromosome_map:
    """Apply a function per chromosome when given grouped streams or
    grouped dicts; pass through otherwise."""

    def __init__(self, reduction=None):
        self._reduction = reduction

    @staticmethod
    def is_grouped_dict(obj) -> bool:
        return hasattr(obj, "grouped_dict_attribute")

    def _iter_args(self, args, kwargs, stream_indices, dict_indices,
                   stream_keys, dict_keys):
        if stream_indices:
            stream = args[stream_indices[0]]
        elif stream_keys:
            stream = kwargs[stream_keys[0]]
        elif dict_indices:
            stream_indices = list(stream_indices) + [dict_indices.pop(0)]
            stream = args[stream_indices[-1]].items()
        else:
            dict_keys = list(dict_keys)
            stream_keys = list(stream_keys) + [dict_keys.pop(0)]
            stream = kwargs[stream_keys[-1]].items()
        dicts = [args[i] for i in dict_indices]
        dicts_kw = [kwargs[key] for key in dict_keys]
        new_args = list(args)
        new_kwargs = dict(kwargs)
        for chromosome, data in stream:
            for i, d in zip(dict_indices, dicts):
                new_args[i] = d[chromosome]
            for key, d in zip(dict_keys, dicts_kw):
                new_kwargs[key] = d[chromosome]
            for i in stream_indices:
                new_args[i] = data
            for key in stream_keys:
                new_kwargs[key] = data
            yield chromosome, list(new_args), dict(new_kwargs)

    def __call__(self, func):
        def mapped(*args, **kwargs):
            stream_indices = [i for i, a in enumerate(args)
                              if isinstance(a, grouped_stream)]
            dict_indices = [i for i, a in enumerate(args)
                            if self.is_grouped_dict(a)]
            stream_keys = [key for key, val in kwargs.items()
                           if isinstance(val, grouped_stream)]
            dict_keys = [key for key, val in kwargs.items()
                         if self.is_grouped_dict(val)]
            is_stream = bool(stream_indices or stream_keys)
            is_dict = not is_stream and bool(dict_indices or dict_keys)
            if not (is_stream or is_dict):
                return func(*args, **kwargs)
            pairs = self._iter_args(args, kwargs, stream_indices,
                                    dict_indices, stream_keys, dict_keys)
            results = ((chromosome, func(*a, **kw))
                       for chromosome, a, kw in pairs)
            if is_stream:
                ret = grouped_stream(results)
            else:
                ret = dict(results)
            if self._reduction is None:
                return ret
            if is_stream:
                return self._reduction(value for _, value in ret)
            return self._reduction(ret.values())
        mapped.__name__ = getattr(func, "__name__", "chromosome_map")
        return mapped
