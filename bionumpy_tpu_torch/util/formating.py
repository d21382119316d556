"""Table pretty-printer (reference: bionumpy/util/formating.py)."""
from __future__ import annotations


def table(rows, headers=None, col_width: int = 20) -> str:
    lines = []
    if headers is not None:
        lines.append("".join(f"{str(h):>{col_width + 5}}" for h in headers))
    for row in rows:
        lines.append("".join(f"{str(cell)[:col_width]:>{col_width + 5}}"
                             for cell in row))
    return "\n".join(lines)
