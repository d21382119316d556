"""Indexed BAM random access (reference: bionumpy/io/indexed_bam.py).

The reference delegates to the optional pysam dependency; this build does
the same and raises a clear error when pysam is unavailable."""
from __future__ import annotations

try:
    import pysam
except ImportError:
    pysam = None


class IndexedBamFile:
    def __init__(self, filename: str, create_index: bool = False):
        if pysam is None:
            raise ImportError(
                "IndexedBamFile requires pysam, which is not installed in "
                "this environment")
        if create_index:
            pysam.index(str(filename))
        self._samfile = pysam.AlignmentFile(filename, "rb")

    def fetch(self, chromosome=None, start=None, stop=None):
        return self._samfile.fetch(chromosome, start, stop)
