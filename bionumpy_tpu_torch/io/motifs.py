"""Motif files by suffix (the port's copy of bionumpy_tpu/io/motifs.py;
reference: bionumpy/io/motifs.py)."""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import PurePath

import numpy as np

from .jaspar import read_csv_motif, read_jaspar_matrix

parsers = {".jaspar": read_jaspar_matrix, ".csv": read_csv_motif}


@dataclass
class Motif:
    alphabet: str
    matrix: np.ndarray


def read_motif(filename: str):
    """The PWM in a `.jaspar` or `.csv` motif file."""
    path = PurePath(filename)
    suffix = path.suffixes[-1]
    return parsers[suffix](filename)
