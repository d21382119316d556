"""File headers (reference: bionumpy/io/headers.py)."""
from __future__ import annotations

from typing import Dict


class SamHeader:
    def __init__(self, header_text: str, contig_dict: Dict[str, int]):
        self._header_text = header_text
        self._contig_dict = contig_dict

    @property
    def contig_dict(self) -> Dict[str, int]:
        return self._contig_dict

    @property
    def text(self) -> str:
        return self._header_text

    @classmethod
    def from_text(cls, text: str) -> "SamHeader":
        contig_lines = (line for line in text.split("\n")
                        if line.startswith("@SQ"))
        contig_dict = dict(cls._get_name_and_length(line)
                           for line in contig_lines)
        return cls(text, contig_dict)

    @classmethod
    def _get_name_and_length(cls, line: str):
        fields = dict(part.split(":", maxsplit=1)
                      for part in line.split()[1:])
        return fields["SN"], int(fields["LN"])
