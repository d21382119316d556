"""GTF-derived annotation interval sets (reference:
bionumpy/genomic_data/annotation.py:6-82; the port's copy of
bionumpy_tpu/genomic_data/annotation.py)."""
from __future__ import annotations

from ..datatypes import GTFEntry
from .genomic_intervals import GenomicIntervalsFull


def _id_field(name):
    """Expose one GTF attribute column of the wrapped intervals."""
    return property(lambda self: getattr(self._intervals, name))


class Genes(GenomicIntervalsFull):
    gene_id = _id_field("gene_id")


class Transcripts(Genes):
    transcript_id = _id_field("transcript_id")


class Exons(Transcripts):
    exon_id = _id_field("exon_id")


class GenomicAnnotation:
    """Holder for gene/transcript/exon interval sets."""

    def __init__(self, data, genome_context):
        self._data = data
        self._genome_context = genome_context
        self._genes = None
        self._transcripts = None
        self._exons = None

    def __repr__(self):
        return (f"GenomicAnnotation(genome_context="
                f"{self._genome_context})")

    @property
    def genes(self) -> Genes:
        if self._genes is None:
            self._genes = Genes(self._data.get_genes(),
                                self._genome_context, True)
        return self._genes

    @property
    def transcripts(self) -> Transcripts:
        if self._transcripts is None:
            self._transcripts = Transcripts(self._data.get_transcripts(),
                                            self._genome_context, True)
        return self._transcripts

    @property
    def exons(self) -> Exons:
        if self._exons is None:
            self._exons = Exons(self._data.get_exons(),
                                self._genome_context, True)
        return self._exons

    @classmethod
    def from_gtf_entries(cls, gtf_entries: GTFEntry,
                         genome_context) -> "GenomicAnnotation":
        return cls(gtf_entries, genome_context)
