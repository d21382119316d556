"""Utility helpers (the part of bionumpy_tpu/util/__init__.py the port
uses so far)."""
from __future__ import annotations

import inspect


def is_subclass_or_instance(obj, cls) -> bool:
    return (inspect.isclass(obj) and issubclass(obj, cls)) or \
        isinstance(obj, cls)
