"""VCF ##-header metadata parsing (reference: bionumpy/io/vcf_header.py)."""
from __future__ import annotations

import re
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, List, Mapping, Optional


@dataclass
class VCFHeader:
    """Parsed ##-metadata of a VCF header, keyed the way the spec names
    its sections (INFO/FORMAT/FILTER/contig maps keyed by ID; scalar
    ##key=value lines as strings; anything else under `optional`)."""
    INFO: Mapping[str, Any] = field(default_factory=dict)
    FORMAT: Mapping[str, Any] = None
    FILTER: Mapping[str, Any] = None
    contig: Mapping[str, Any] = None
    fileformat: str = None
    fileDate: str = None
    source: str = None
    reference: str = None
    optional: Mapping[str, List[Any]] = None


_STRING_IDENTIFIERS = {"fileformat", "fileDate", "source", "reference"}
_MAPPING_IDENTIFIERS = {"FILTER", "FORMAT", "INFO", "contig"}

_TYPE_MAP = {"Float": Optional[float], "Integer": Optional[int],
             "Flag": bool, "String": str}

_FIELD_REGEX = {
    "ID": r"=(.+?)[,>]",
    "Number": r"=(.+?)[,>]",
    "Type": r"=(.+?)[,>]",
    "Description": r'="(.+?)"',
}


def _preprocess_number(x: str) -> Optional[int]:
    match = re.match(r"(\d)", x)
    return int(match.group(1)) if match else None


_PREPROCESSORS = {
    "ID": lambda x: x,
    "Number": _preprocess_number,
    "Type": lambda x: _TYPE_MAP[x],
    "Description": lambda x: x,
}


def _extract_identifier_and_content(line: str):
    match = re.search(r"^##(\S+?)=(.*)$", line)
    if match:
        return match.group(1), match.group(2)
    warnings.warn(f"Header line not in ##key=value format: {line}",
                  RuntimeWarning)
    return None, None


def _parse_mapping_content(content: str) -> dict:
    results = {}
    for name, preprocess in _PREPROCESSORS.items():
        match = re.search(f"{name}{_FIELD_REGEX[name]}", content)
        if match:
            results.setdefault(name, preprocess(match.group(1)))
    return results


def parse_header(lines: str) -> VCFHeader:
    headers = {}
    for line in lines.split("\n"):
        if not line.startswith("##"):
            continue
        identifier, content = _extract_identifier_and_content(line)
        if identifier is None:
            continue
        if identifier in _STRING_IDENTIFIERS:
            headers[identifier] = content
        elif identifier in _MAPPING_IDENTIFIERS:
            mapping = _parse_mapping_content(content)
            target = headers.setdefault(identifier, OrderedDict())
            if mapping.get("ID"):
                target[mapping["ID"]] = mapping
            else:
                target.setdefault("Without ID", []).append(mapping)
        else:
            headers.setdefault("optional", {}).setdefault(
                identifier, []).append(content)
    return VCFHeader(**{k: v for k, v in headers.items()
                        if k in VCFHeader.__dataclass_fields__})
