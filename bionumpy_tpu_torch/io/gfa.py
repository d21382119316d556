"""GFA path records (reference: bionumpy/io/gfa.py).

Parses P-lines whose third column is a comma-separated list of node ids
with +/- orientations into ragged integer arrays."""
from __future__ import annotations

import numpy as np

from ..datatypes import GfaPath
from ..encoded_array import EncodedArray, EncodedRaggedArray
from ..ragged import RaggedArray, RaggedShape, RaggedView
from .delimited_buffers import DelimitedBuffer
from .strops import str_to_int


class GfaPathBuffer(DelimitedBuffer):
    dataclass = GfaPath
    SKIP_LAZY = True  # node list needs the custom get_data parse

    def get_data(self) -> GfaPath:
        name = self.get_text(1)
        nodes_lists = self.get_text(2)
        flat = nodes_lists.ravel()
        raw = np.asarray(flat.raw())
        lengths = np.asarray((nodes_lists == ",").sum(axis=-1)) + 1
        # per row: items split at commas; each item is digits + [+-]
        row_bounds = np.insert(np.cumsum(nodes_lists.lengths), 0, 0)
        items_start, items_end = [], []
        for r in range(len(nodes_lists)):
            lo, hi = int(row_bounds[r]), int(row_bounds[r + 1])
            commas = np.flatnonzero(raw[lo:hi] == ord(",")) + lo
            items_start.append(np.insert(commas + 1, 0, lo))
            items_end.append(np.append(commas, hi))
        items_start = np.concatenate(items_start) if items_start else \
            np.empty(0, dtype=int)
        items_end = np.concatenate(items_end) if items_end else \
            np.empty(0, dtype=int)
        # digits per item exclude the trailing +/- orientation char
        view = RaggedView(items_start, items_end - items_start - 1)
        digit_flat = raw[view.get_flat_indices()]
        node_ids = str_to_int(EncodedRaggedArray(
            EncodedArray(digit_flat, flat.encoding),
            RaggedShape(items_end - items_start - 1)))
        orient = raw[items_end - 1]
        directions = np.where(orient == ord("+"), 1, -1)
        return GfaPath(name,
                       RaggedArray(np.asarray(node_ids), lengths),
                       RaggedArray(directions, lengths))
