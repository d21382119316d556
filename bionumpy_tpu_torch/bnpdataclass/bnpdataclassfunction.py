"""Field replacement helpers (reference:
bionumpy/bnpdataclass/bnpdataclassfunction.py:14-57)."""
from __future__ import annotations

import dataclasses
import functools


def replace(obj, **kwargs):
    """Return a copy of a BNPDataClass (or lazy variant) with some fields
    replaced."""
    if hasattr(obj, "__replace__"):
        return obj.__replace__(**kwargs)
    current = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    current.update(kwargs)
    return obj.__class__(**current)


def apply_to_npdataclass(attribute_name):
    """Decorator: apply a function to one field of a record batch, returning
    the batch with that field replaced."""
    def decorator(func):
        @functools.wraps(func)
        def new_func(data, *args, **kwargs):
            if not dataclasses.is_dataclass(data) and \
                    not hasattr(data, "get_data_object"):
                return func(data, *args, **kwargs)
            if hasattr(data, "get_data_object"):
                data = data.get_data_object()
            return replace(
                data, **{attribute_name:
                         func(getattr(data, attribute_name), *args, **kwargs)})
        return new_func
    return decorator
