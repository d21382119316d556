"""Lazy streamed-expression graph with a push-based single-pass executor
(the port's copy of bionumpy_tpu/computation_graph.py).

Replaces the reference's pull-based node protocol (each node recursively
asking its inputs for buffer *i*, reference: bionumpy/
computation_graph.py:48-217) with a split between

  * **expression nodes** — immutable descriptions of per-chunk work
    (`StreamNode` wraps a chunk source, `ComputationNode` a function of
    other nodes, `ReductionNode` an associative fold), built implicitly
    through the numpy protocols, and
  * **one executor** (`_SinglePass`) that drives every source in
    lock-step, evaluates each node at most once per chunk (memoised per
    round, so shared sub-expressions are not recomputed), updates fold
    accumulators in place, and concatenates map outputs — all roots of a
    `compute({...})` call share a single pass over the file.

The fold algebra is the associative/commutative combiner set the whole
framework shares (sum, padded-bincount add, histogram add, (sum, n) for
mean).  Accumulators keep whatever residency their chunk values have:
when the per-chunk map returns torch tensors on the card (e.g. the
partials of ops.tracks.binned_pileup), every combiner is a torch op on
that tensor's device and the fold state never leaves it; numpy chunks
fold in numpy exactly as in the JAX package, dtypes included.
"""
from __future__ import annotations

import functools
import operator
import traceback
from typing import Any, Callable, Dict, List

import numpy as np
import torch


class ComputationException(Exception):
    """Raised when evaluating a graph node fails; carries the build-site
    stack so streamed errors point at user code, not the executor."""


def _origin(skip: int = 3, depth: int = 5) -> str:
    """Short build-site traceback for error attribution."""
    frames = traceback.extract_stack()[:-skip]
    return "".join(traceback.format_list(frames[-depth:]))


class Reduction:
    """An associative fold: combine(state, state) with an optional
    finalize.  Instances are shared, stateless descriptions."""

    def __init__(self, combine: Callable, finalize: Callable = None,
                 prepare: Callable = None):
        self.combine = combine
        self.finalize = finalize
        self.prepare = prepare  # per-chunk pre-map applied before fold


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _same_edges(a, b) -> bool:
    if _is_tensor(a):
        return a.shape == b.shape and bool(torch.equal(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _histogram_combine(a, b):
    if not _same_edges(a[1], b[1]):
        raise ComputationException(
            "histogram chunks disagree on bin edges")
    return a[0] + b[0], a[1]


def _sum_with_count(array, axis=None):
    """Per-chunk (sum, n) pair for streamed means.  axis=0 over a ragged
    chunk counts, per column, the rows long enough to reach it."""
    if _is_tensor(array):
        return _tensor_sum_with_count(array, axis)
    if getattr(array, "size", None) == 0:
        return 0, 0
    s = np.sum(array, axis=axis)
    if axis is None:
        return s, array.size
    if axis not in (0, -2):
        raise ComputationException(f"streamed mean: unsupported {axis=}")
    lengths = getattr(array, "lengths", None)
    if lengths is None:
        return s, len(array)
    lengths = np.asarray(lengths)
    width = int(lengths.max()) if len(lengths) else 0
    return s, (lengths[:, None] > np.arange(width)).sum(axis=0)


def _tensor_sum_with_count(array, axis):
    """_sum_with_count of a tensor chunk, on its device."""
    if array.numel() == 0:
        return 0, 0
    if axis is None:
        return array.sum(), array.numel()
    if axis not in (0, -2):
        raise ComputationException(f"streamed mean: unsupported {axis=}")
    return array.sum(dim=0), len(array)


def _bincount_combine(a, b):
    """Pad-and-add two count vectors (the reference's bincount_reduce
    algebra, reference: bionumpy/streams/reductions.py:6-14)."""
    if _is_tensor(a):
        return _tensor_bincount_combine(a, b)
    if a.size < b.size:
        a, b = b, a
    out = a.copy()
    out[: b.size] += b
    return out


def _tensor_bincount_combine(a, b):
    """_bincount_combine of tensors, on their device."""
    if a.numel() < b.numel():
        a, b = b, a
    out = a.clone()
    out[: b.numel()] += b
    return out


def _flat_bincount(array, *args, **kwargs):
    if _is_tensor(array):
        return torch.bincount(array.reshape(-1), *args, **kwargs)
    values = array.ravel() if hasattr(array, "ravel") else array
    if hasattr(values, "raw"):
        values = values.raw()
    return np.bincount(np.asarray(values), *args, **kwargs)


class _QuantileFold:
    """Streamed quantile of non-negative ints: per-chunk bincounts
    pad-add into one spectrum, quantiles read off its cumulative sum
    (the reference's one-pass recipe, reference:
    bionumpy/streams/reductions.py:60-66)."""

    def __init__(self, quantiles):
        self._quantiles = np.asarray(quantiles)

    def finalize(self, counts):
        if _is_tensor(counts):
            cumulative = torch.cumsum(counts, 0)
            quantiles = torch.as_tensor(self._quantiles,
                                        device=counts.device)
            return torch.searchsorted(cumulative,
                                      quantiles * cumulative[-1])
        cumulative = np.cumsum(counts)
        return np.searchsorted(cumulative,
                               self._quantiles * cumulative[-1])


def _moments(array, axis=None):
    """(sum, sum of squares, n) for streamed variance/std."""
    if _is_tensor(array):
        flat = array.reshape(-1).to(torch.float64)
        return flat.sum(), flat.square().sum(), flat.numel()
    flat = array.ravel() if hasattr(array, "ravel") else \
        np.asarray(array).ravel()
    flat = np.asarray(flat, dtype=np.float64)
    return flat.sum(), np.square(flat).sum(), flat.size


def _maximum(a, b):
    if _is_tensor(a) and _is_tensor(b):
        return torch.maximum(a, b)
    return np.maximum(a, b)


def _minimum(a, b):
    if _is_tensor(a) and _is_tensor(b):
        return torch.minimum(a, b)
    return np.minimum(a, b)


def _sqrt(x):
    return torch.sqrt(x) if _is_tensor(x) else np.sqrt(x)


def _concatenate(chunks):
    """A map root's chunks as one value: torch.cat for tensors (on their
    device), np.concatenate otherwise."""
    if all(_is_tensor(c) for c in chunks):
        return torch.cat(chunks)
    return np.concatenate(chunks)


SUM = Reduction(lambda a, b: a + b)
HISTOGRAM = Reduction(_histogram_combine)
MEAN = Reduction(lambda a, b: (a[0] + b[0], a[1] + b[1]),
                 finalize=lambda sn: sn[0] / sn[1],
                 prepare=_sum_with_count)
BINCOUNT = Reduction(_bincount_combine, prepare=_flat_bincount)
MAX = Reduction(_maximum)
MIN = Reduction(_minimum)
VAR = Reduction(lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2]),
                finalize=lambda s: s[1] / s[2] - (s[0] / s[2]) ** 2,
                prepare=_moments)
STD = Reduction(VAR.combine,
                finalize=lambda s: _sqrt(VAR.finalize(s)),
                prepare=_moments)

def _tensor_sum(array, axis=None):
    return array.sum() if axis is None else array.sum(dim=axis)


def _tensor_max(array, axis=None):
    return array.amax() if axis is None else array.amax(dim=axis)


def _tensor_min(array, axis=None):
    return array.amin() if axis is None else array.amin(dim=axis)


# numpy functions whose per-chunk map runs as a torch op when a chunk is a
# tensor: the reducers, and the ufuncs behind a node's Python operators
# (np.lib.mixins.NDArrayOperatorsMixin), as those operators
_TENSOR_FUNCS = {
    np.sum: _tensor_sum, np.max: _tensor_max, np.amax: _tensor_max,
    np.min: _tensor_min, np.amin: _tensor_min,
    np.add: operator.add, np.subtract: operator.sub,
    np.multiply: operator.mul, np.true_divide: operator.truediv,
    np.floor_divide: operator.floordiv, np.remainder: operator.mod,
    np.power: operator.pow, np.equal: operator.eq,
    np.not_equal: operator.ne, np.less: operator.lt,
    np.less_equal: operator.le, np.greater: operator.gt,
    np.greater_equal: operator.ge, np.bitwise_and: operator.and_,
    np.bitwise_or: operator.or_, np.bitwise_xor: operator.xor,
    np.negative: operator.neg, np.absolute: operator.abs,
    np.invert: operator.invert}


def _chunk_func(func):
    """`func` as the per-chunk map: on tensor chunks, its torch twin from
    _TENSOR_FUNCS, on the chunks' device."""
    tensor_func = _TENSOR_FUNCS.get(func)
    if tensor_func is None:
        return func

    @functools.wraps(func)
    def apply(*args, **kwargs):
        if any(_is_tensor(a) for a in args):
            return tensor_func(*args, **kwargs)
        return func(*args, **kwargs)
    return apply


# numpy entry points that become streamed folds when applied to a node
_FOLDS = {np.sum: SUM, np.histogram: HISTOGRAM}

# whole-stream (axis=None) folds for further numpy reducers: the
# per-chunk map IS the prepare when None, the combine merges chunks
_AXIS_NONE_FOLDS = {np.max: MAX, np.amax: MAX, np.min: MIN,
                    np.amin: MIN, np.var: VAR, np.std: STD}

# kept importable: other modules historically used these names
sum_and_n = _sum_with_count
mean_reduction = MEAN.combine


def _resolve_reductions(values):
    """Auto-compute any ReductionNode appearing as an INPUT to further
    math: the fold runs its own pass immediately and its concrete
    result is substituted (so `np.sqrt(x.mean())` just works).  The
    consumed source cannot be re-streamed — if the surrounding
    expression still references the same stream, its pass will find it
    exhausted and fail loudly ("empty stream")."""
    return tuple(v.compute() if isinstance(v, ReductionNode) else v
                 for v in values)


class Node(np.lib.mixins.NDArrayOperatorsMixin):
    """Base of the expression graph.  Arithmetic/ufuncs/most numpy
    functions map per chunk; np.sum/np.histogram/np.bincount/
    np.mean(axis None|0)/np.quantile become streamed folds; row-axis
    reductions (mean/max/sum with axis=-1) map per chunk and
    concatenate, the reference's _rowmean semantics (reference:
    bionumpy/streams/reductions.py:46-57)."""

    def __array_ufunc__(self, ufunc, method, *args, **kwargs):
        if method != "__call__":
            return NotImplemented
        args = _resolve_reductions(args)
        if not any(isinstance(a, Node) for a in args):
            return ufunc(*args, **kwargs)  # all folds resolved: eager
        return ComputationNode(_chunk_func(ufunc), args, kwargs)

    def __array_function__(self, func, types, args, kwargs):
        args = _resolve_reductions(args)
        kwargs = dict(zip(kwargs, _resolve_reductions(kwargs.values())))
        if not any(isinstance(a, Node)
                   for a in list(args) + list(kwargs.values())):
            return func(*args, **kwargs)
        if func is np.mean and kwargs.get("axis") in (None, 0):
            return ReductionNode(
                ComputationNode(MEAN.prepare, args, kwargs), MEAN)
        if func in _AXIS_NONE_FOLDS and kwargs.get("axis") is None:
            fold = _AXIS_NONE_FOLDS[func]
            if fold.prepare is not None:
                mapped = ComputationNode(fold.prepare, args, kwargs)
            else:  # the reducer itself is the per-chunk map
                mapped = ComputationNode(_chunk_func(func), args, kwargs)
            return ReductionNode(mapped, fold)
        if func is np.bincount:
            return ReductionNode(
                ComputationNode(BINCOUNT.prepare, args, kwargs), BINCOUNT)
        if func is np.quantile and kwargs.get("axis") is None:
            node, quantiles = args[0], args[1] if len(args) > 1 \
                else kwargs["q"]
            fold = _QuantileFold(quantiles)
            return ReductionNode(
                ComputationNode(_flat_bincount, (node,)),
                Reduction(_bincount_combine, finalize=fold.finalize))
        mapped = ComputationNode(_chunk_func(func), args, kwargs)
        fold = _FOLDS.get(func)
        return ReductionNode(mapped, fold) if fold else mapped

    # convenience methods mirroring the array API
    def sum(self, *args, **kwargs):
        return np.sum(self, *args, **kwargs)

    def mean(self, axis=None):
        if axis not in (None, 0, 1, -1):
            raise ValueError(f"invalid axis for streamed mean: {axis}")
        return np.mean(self, axis=axis)

    def max(self, axis=None, **kwargs):
        if axis not in (None, -1):
            raise ValueError("streamed max supports axis in {None, -1}")
        return np.max(self, axis=axis, **kwargs)

    def min(self, axis=None, **kwargs):
        if axis not in (None, -1):
            raise ValueError("streamed min supports axis in {None, -1}")
        return np.min(self, axis=axis, **kwargs)

    def std(self, axis=None):
        if axis is not None:
            raise ValueError("streamed std supports axis=None")
        return np.std(self, axis=None)

    def var(self, axis=None):
        if axis is not None:
            raise ValueError("streamed var supports axis=None")
        return np.var(self, axis=None)

    def quantile(self, quantiles):
        return np.quantile(self, quantiles)

    def bincount(self, **kwargs):
        return np.bincount(self, **kwargs)

    def __getitem__(self, item):
        return ComputationNode(lambda chunk, it: chunk[it], (self, item))

    def compute(self):
        """Evaluate this node alone (one pass over its sources)."""
        return _SinglePass([self]).run()[0]

    def get_iter(self):
        """Yield this node's per-chunk values (one streaming pass) —
        used by consumers that fold chunk-wise themselves (e.g. the
        per-chromosome genomic track assembly)."""
        return _SinglePass([self]).iter_chunks(self)

    def __repr__(self):
        return f"<streamed {type(self).__name__}>"


class StreamNode(Node):
    """Graph source: a stream/iterator of per-chunk values."""

    def __init__(self, stream):
        self._iterator = iter(stream)

    def _next_chunk(self):
        return next(self._iterator)


class ComputationNode(Node):
    """A function applied chunk-wise to other nodes and constants."""

    def __init__(self, func, args, kwargs=None, stack_trace=None):
        self._func = func
        self._args = tuple(args)
        self._kwargs = dict(kwargs) if kwargs else {}
        self._where = stack_trace if stack_trace is not None else _origin()

    def _apply(self, args, kwargs):
        try:
            return self._func(*args, **kwargs)
        except (StopIteration, ComputationException):
            raise
        except Exception as err:
            raise ComputationException(
                f"streamed evaluation of {self._func} failed; built "
                f"at:\n{self._where}") from err


class ReductionNode(Node):
    """A fold of an upstream node's chunks with an associative
    combiner."""

    def __init__(self, upstream: Node, reduction, post_process=None):
        self._upstream = upstream
        if not isinstance(reduction, Reduction):
            # legacy calling convention: a raw binary function
            reduction = Reduction(reduction, finalize=post_process)
        elif post_process is not None:
            reduction = Reduction(reduction.combine, finalize=post_process,
                                  prepare=reduction.prepare)
        self._reduction = reduction


class _SinglePass:
    """Executor: advances every source once per round, evaluates the
    memoised DAG, updates fold states, collects map outputs."""

    _EMPTY = object()

    def __init__(self, roots: List[Node]):
        self._roots = list(roots)
        self._sources: List[StreamNode] = []
        seen = set()
        stack = [r for r in self._roots if isinstance(r, Node)]
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            if isinstance(node, StreamNode):
                self._sources.append(node)
            elif isinstance(node, ReductionNode):
                stack.append(node._upstream)
            elif isinstance(node, ComputationNode):
                stack.extend(a for a in node._args if isinstance(a, Node))
                stack.extend(v for v in node._kwargs.values()
                             if isinstance(v, Node))

    def _evaluate(self, node: Node, memo: Dict[int, Any]):
        key = id(node)
        if key in memo:
            return memo[key]
        if isinstance(node, ReductionNode):
            raise ComputationException(
                "a streamed reduction cannot feed per-chunk math; "
                "compute() it first")
        args = [self._evaluate(a, memo) if isinstance(a, Node) else a
                for a in node._args]
        kwargs = {k: self._evaluate(v, memo) if isinstance(v, Node) else v
                  for k, v in node._kwargs.items()}
        memo[key] = result = node._apply(args, kwargs)
        return result

    def iter_chunks(self, root: Node):
        """Generator over `root`'s per-chunk values."""
        if isinstance(root, ReductionNode):
            raise ComputationException(
                "a streamed reduction has no per-chunk values")
        while True:
            memo: Dict[int, Any] = {}
            try:
                for src in self._sources:
                    memo[id(src)] = src._next_chunk()
            except StopIteration:
                return
            yield self._evaluate(root, memo)

    def run(self) -> List[Any]:
        states = [self._EMPTY] * len(self._roots)  # fold accumulators
        chunks: List[List[Any]] = [[] for _ in self._roots]
        while True:
            memo: Dict[int, Any] = {}
            try:
                for src in self._sources:
                    memo[id(src)] = src._next_chunk()
            except StopIteration:
                break
            for i, root in enumerate(self._roots):
                if isinstance(root, ReductionNode):
                    value = self._evaluate(root._upstream, memo)
                    if states[i] is self._EMPTY:
                        states[i] = value
                    else:
                        states[i] = root._reduction.combine(states[i],
                                                            value)
                elif isinstance(root, Node):
                    chunks[i].append(self._evaluate(root, memo))
        out = []
        for i, root in enumerate(self._roots):
            if isinstance(root, ReductionNode):
                state = states[i]
                if state is self._EMPTY:
                    raise ComputationException(
                        "streamed reduction over an empty stream")
                fin = root._reduction.finalize
                out.append(fin(state) if fin else state)
            elif isinstance(root, Node):
                if not chunks[i]:
                    raise ComputationException(
                        "streamed expression over an empty stream")
                out.append(_concatenate(chunks[i]))
            else:
                out.append(root)
        return out


def compute(args):
    """Evaluate one node, or several together in a SINGLE pass over the
    underlying file(s): accepts a Node, a list/tuple, or a dict of
    nodes (non-node values pass through untouched)."""
    if isinstance(args, dict):
        return dict(zip(args, _SinglePass(list(args.values())).run()))
    if isinstance(args, (list, tuple)):
        return type(args)(_SinglePass(list(args)).run())
    if isinstance(args, Node):
        return args.compute()
    return args
