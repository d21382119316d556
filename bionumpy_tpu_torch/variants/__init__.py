"""Variants: SBS96 mutation-type counting and applying variants to
sequences (the port's copy of bionumpy_tpu/variants/)."""
from .consensus import apply_variants, apply_variants_to_sequence
from .mutation_signature import (MutationTypeEncoding,
                                 count_mutation_types,
                                 count_mutation_types_genomic)

__all__ = ["count_mutation_types_genomic", "count_mutation_types",
           "MutationTypeEncoding", "apply_variants",
           "apply_variants_to_sequence"]
