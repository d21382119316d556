"""Interval arithmetic: pileups, boolean masks, sorting, merging and
intersecting intervals, and the jaccard and forbes similarities over
synchronised per-chromosome streams (the port's copy of
bionumpy_tpu/arithmetics/)."""
from .intervals import (GenomicRunLengthArray, clip, count_overlap, extend,
                        extend_to_size, fast_sort_intervals,
                        get_boolean_mask, get_pileup, get_pileup_device,
                        global_intersect,
                        intersect, merge_intervals, sort_intervals,
                        unique_intersect)
from .similarity_measures import forbes, get_contingency_table, jaccard

__all__ = ["get_pileup", "get_pileup_device", "get_boolean_mask", "intersect",
           "global_intersect", "unique_intersect", "merge_intervals",
           "sort_intervals", "fast_sort_intervals", "count_overlap",
           "extend", "extend_to_size", "clip", "forbes", "jaccard",
           "get_contingency_table", "GenomicRunLengthArray"]
