"""Keyed left join of two grouped streams (reference:
bionumpy/streams/left_join.py; the port's copy of
bionumpy_tpu/streams/left_join.py)."""
from __future__ import annotations

from typing import Any, Iterable, Tuple


def left_join(grouped_left: Iterable[Tuple[str, Any]],
              grouped_right: Iterable[Tuple[str, Any]]
              ) -> Iterable[Tuple[str, Any, Any]]:
    grouped_right = iter(grouped_right)
    name_right, data_right = next(grouped_right, (None, None))
    for name_left, data_left in grouped_left:
        if name_left != name_right:
            yield (name_left, data_left, None)
            continue
        yield (name_left, data_left, data_right)
        name_right, data_right = next(grouped_right, (None, None))
    if name_right is not None:
        raise ValueError(f"Data left in right group: {name_right}")
