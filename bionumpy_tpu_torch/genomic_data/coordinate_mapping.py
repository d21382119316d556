"""Locations -> interval-relative coordinates via double searchsorted
(reference: bionumpy/genomic_data/coordinate_mapping.py:10-52; the port's
copy of bionumpy_tpu/genomic_data/coordinate_mapping.py)."""
from __future__ import annotations

import numpy as np

from ..bnpdataclass import replace
from ..string_array import StringArray


def find_indices(sorted_positions: np.ndarray, intervals):
    """(location_indices, interval_indices) pairing each sorted position
    with every interval containing it."""
    starts = np.asarray(intervals.start)
    stops = np.asarray(intervals.stop)
    interval_start = np.searchsorted(sorted_positions, starts, side="left")
    interval_stop = np.searchsorted(sorted_positions, stops, side="right")
    n_locations = interval_stop - interval_start
    interval_indices = np.repeat(np.arange(len(starts)), n_locations)
    change_indices = np.insert(np.cumsum(n_locations)[:-1], 0, 0)
    location_indices = np.arange(len(interval_indices)) - \
        np.repeat(change_indices - interval_start, n_locations)
    return location_indices, interval_indices


def map_locations(locations, intervals):
    """Map (sorted-position) locations to containing intervals."""
    location_indices, interval_indices = find_indices(
        np.asarray(locations.position), intervals)
    new_entries = locations[location_indices]
    names = intervals.name if hasattr(intervals, "name") else \
        StringArray(np.arange(len(intervals)).astype("S"))
    return replace(new_entries, chromosome=names[interval_indices],
                   position=np.asarray(new_entries.position) -
                   np.asarray(intervals.start)[interval_indices])
