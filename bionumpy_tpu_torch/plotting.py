"""Plotting dispatch for analysis results (the port's copy of
bionumpy_tpu/plotting.py; reference: bionumpy/plotting.py).  matplotlib
is imported at the first plot, never with the package."""
from __future__ import annotations

import dataclasses

import numpy as np

from .encoded_array import EncodedRaggedArray
from .genomic_data import GenomicArray, GenomicIntervals
from .io.matrix_dump import Matrix
from .ragged.rle import RunLengthArray
from .sequence.count_encoded import EncodedCounts


@dataclasses.dataclass
class Vector:
    """Named 1-D data, the bar-chart payload."""
    data: np.ndarray
    names: list


def _import_pyplot():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        return None


class Plotter:
    def __init__(self, plt=None):
        self._tried = plt is not None
        self._show = True
        self._plt = plt

    @property
    def plt(self):
        if not self._tried:
            self._tried = True
            self._plt = _import_pyplot()
        return self._plt

    def set_config(self, **kwargs):
        for key, value in kwargs.items():
            assert key in {"show"}
            if key == "show":
                self._show = value

    def show(self, fig=None):
        if not self._show or self.plt is None:
            return
        self.plt.show()

    def _conversion(self, data):
        if isinstance(data, GenomicIntervals):
            return data.get_pileup()
        if isinstance(data, EncodedCounts):
            if len(data.counts.shape) == 2:
                return Matrix(data.counts, col_names=data.alphabet)
            return Vector(data.counts, names=data.alphabet)
        return data

    def _plot_bars(self, vector: Vector):
        fig, ax = self.plt.subplots()
        ax.bar([str(c) for c in vector.names], vector.data)
        self.show(fig)

    def _plot_heatmap(self, matrix: Matrix):
        fig, ax = self.plt.subplots()
        data = np.asarray(matrix.data)
        n_rows, n_cols = data.shape
        ax.imshow(data)
        ax.set_xticks(np.arange(n_cols))
        if matrix.col_names is not None:
            names = matrix.col_names.tolist() \
                if isinstance(matrix.col_names, EncodedRaggedArray) \
                else matrix.col_names
            ax.set_xticklabels(names)
        ax.set_yticks(np.arange(n_rows))
        if matrix.row_names is not None:
            names = matrix.row_names.tolist() \
                if isinstance(matrix.row_names, EncodedRaggedArray) \
                else matrix.row_names
            ax.set_yticklabels(names)
        self.plt.setp(ax.get_xticklabels(), rotation=45, ha="right",
                      rotation_mode="anchor")
        fig.tight_layout()
        self.show(fig)

    def _plot_single(self, data, ax=None, label=None):
        if ax is None:
            _, ax = self.plt.subplots()
        if isinstance(data, RunLengthArray):
            ax.plot(np.asarray(data.to_array()), label=label)
        else:
            ax.plot(np.asarray(data), label=label)

    def _plot_genomic_array(self, track: GenomicArray):
        gc = track.genome_context
        fig, axes = self.plt.subplots(1, len(gc.chrom_sizes), sharey=True)
        axes = np.atleast_1d(axes)
        for i, chromosome in enumerate(gc.chrom_sizes.keys()):
            axes[i].plot(np.asarray(track[chromosome].to_array()))
            axes[i].title.set_text(chromosome)
        self.show(fig)

    def plot(self, data):
        if self.plt is None:
            raise RuntimeError("matplotlib is not available")
        data = self._conversion(data)
        if isinstance(data, Vector):
            return self._plot_bars(data)
        if isinstance(data, Matrix):
            return self._plot_heatmap(data)
        if isinstance(data, GenomicArray):
            return self._plot_genomic_array(data)
        if isinstance(data, RunLengthArray):
            fig, ax = self.plt.subplots()
            self._plot_single(data, ax=ax)
            return self.show(fig)
        if isinstance(data, np.ndarray):
            fig, ax = self.plt.subplots()
            ax.plot(data)
            return self.show(fig)
        raise NotImplementedError(f"cannot plot {type(data)}")

    __call__ = plot


plotter = Plotter()
plot = plotter
show = plotter.show
