"""Genome-wide coordinates (the part of bionumpy_tpu/genomic_data/ ported
so far: GlobalOffset, which pipeline.binned_pileup_bed uses)."""
from .global_offset import GlobalOffset

__all__ = ["GlobalOffset"]
