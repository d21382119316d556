"""The port's streamed expression graph (computation_graph.py) against the
JAX package's, on the CPU: the same seeded chunks through both graphs,
every fold, map roots, mixed roots in one pass, shared sub-expressions,
error attribution and the reduction-reuse error, with values and dtypes
equal.  Folds over torch partials (device="cpu") stay torch tensors on
their device and equal the JAX package's fold over jnp partials (over
numpy partials for BINCOUNT, whose in-place pad-add JAX arrays refuse)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bionumpy_tpu import computation_graph as jcg
from bionumpy_tpu.ops.tracks import binned_pileup as jax_binned_pileup
from bionumpy_tpu.ragged import RaggedArray as JRagged
from bionumpy_tpu_torch import computation_graph as tcg
from bionumpy_tpu_torch.ops.tracks import binned_pileup as torch_binned_pileup
from bionumpy_tpu_torch.ragged import RaggedArray as TRagged

SEEDS = [0, 1, 2]


def _chunks(seed, kind="int"):
    """Seeded chunks of uneven lengths (one of them a single value)."""
    rng = np.random.default_rng(seed)
    sizes = [int(n) for n in rng.integers(1, 40, 4)] + [1]
    if kind == "float":
        return [rng.normal(size=n) * 10 for n in sizes]
    if kind == "2d":
        return [rng.integers(0, 50, (n, 3)) for n in sizes]
    return [rng.integers(0, 60, n) for n in sizes]


def assert_same(got, want):
    """Equal values with the same dtype, element by element through
    tuples and lists; numpy scalars and 0-d arrays compare as arrays."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
        return
    if isinstance(want, (np.ndarray, np.generic)):
        got_a, want_a = np.asarray(got), np.asarray(want)
        assert got_a.dtype == want_a.dtype
        assert got_a.shape == want_a.shape
        np.testing.assert_array_equal(got_a, want_a)
        return
    assert type(got) is type(want)
    assert got == want


# each case: (chunk kind, expression over a StreamNode); `np` functions
# route through the graph's numpy protocols in both packages
FOLDS = {
    "sum": ("int", lambda cg, n: np.sum(n)),
    "sum-float": ("float", lambda cg, n: np.sum(n)),
    "sum-method": ("int", lambda cg, n: n.sum()),
    "mean": ("float", lambda cg, n: np.mean(n)),
    "mean-int": ("int", lambda cg, n: n.mean()),
    "mean-axis0": ("2d", lambda cg, n: np.mean(n, axis=0)),
    "max": ("float", lambda cg, n: np.max(n)),
    "min": ("int", lambda cg, n: n.min()),
    "var": ("float", lambda cg, n: np.var(n)),
    "std": ("float", lambda cg, n: n.std()),
    "bincount": ("int", lambda cg, n: np.bincount(n)),
    "bincount-minlength": ("int", lambda cg, n: n.bincount(minlength=70)),
    "histogram": ("float", lambda cg, n: np.histogram(
        n, bins=np.linspace(-30, 30, 7))),
    "quantile": ("int", lambda cg, n: np.quantile(n, [0.1, 0.5, 0.9])),
    "arith-concat": ("int", lambda cg, n: n * 3 + 1),
    "ufunc-concat": ("float", lambda cg, n: np.abs(n)),
    "getitem-concat": ("int", lambda cg, n: n[1:]),
    "rowmax-concat": ("2d", lambda cg, n: n.max(axis=-1)),
    "sum-of-map": ("int", lambda cg, n: np.sum(n * n)),
    "legacy-fold": ("int", lambda cg, n: cg.ReductionNode(
        n, lambda a, b: a + b.sum(), post_process=lambda s: s * 2)),
    "fold-finalize": ("int", lambda cg, n: cg.ReductionNode(
        cg.ComputationNode(np.sum, [n]), cg.SUM,
        post_process=lambda s: s - 1)),
}


def _run(cg, seed, case):
    kind, build = FOLDS[case]
    node = cg.StreamNode(iter(_chunks(seed, kind)))
    return cg.compute(build(cg, node))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(FOLDS))
def test_folds_and_maps_match_jax(case, seed):
    assert_same(_run(tcg, seed, case), _run(jcg, seed, case))


@pytest.mark.parametrize("seed", SEEDS)
def test_ragged_rowmean_concatenates(seed):
    rng = np.random.default_rng(seed)

    def run(cg, ragged):
        chunks = []
        for _ in range(3):
            lengths = rng.integers(1, 6, 4)
            chunks.append(ragged(rng.normal(size=int(lengths.sum())),
                                 lengths))
        return cg.StreamNode(iter(chunks)).mean(axis=-1).compute()

    state = rng.bit_generator.state
    got = run(tcg, TRagged)
    rng.bit_generator.state = state
    assert_same(got, run(jcg, JRagged))


def _mixed(cg):
    pulls = []

    def counting():
        for i in range(3):
            pulls.append(i)
            yield np.full(4, float(i))

    node = cg.StreamNode(counting())
    doubled = node * 2
    out = cg.compute({"cat": doubled, "total": np.sum(doubled),
                      "mean": np.mean(node), "const": 7})
    return pulls, out


def test_mixed_roots_single_pass():
    (t_pulls, got), (j_pulls, want) = _mixed(tcg), _mixed(jcg)
    assert t_pulls == j_pulls == [0, 1, 2]
    assert list(got) == list(want)
    for key in want:
        assert_same(got[key], want[key])


@pytest.mark.parametrize("container", [list, tuple])
def test_compute_of_a_container_keeps_its_type(container):
    def run(cg):
        node = cg.StreamNode(iter([np.arange(3), np.arange(5)]))
        return cg.compute(container([np.sum(node), node + 1, "x"]))
    got, want = run(tcg), run(jcg)
    assert type(got) is container
    assert_same(list(got), list(want))


def _shared(cg):
    calls = []

    def spy(x):
        calls.append(1)
        return x + 1

    node = cg.StreamNode(iter([np.arange(3), np.arange(3)]))
    shared = cg.ComputationNode(spy, [node])
    return calls, cg.compute([np.sum(shared), np.sum(shared * 2)])


def test_shared_subexpression_evaluated_once():
    (t_calls, got), (j_calls, want) = _shared(tcg), _shared(jcg)
    assert len(t_calls) == len(j_calls) == 2
    assert_same(got, want)


def test_error_attribution_carries_the_build_site():
    node = tcg.StreamNode(iter([np.arange(3)]))
    bad = tcg.ComputationNode(lambda x: x[100], [node])
    with pytest.raises(tcg.ComputationException,
                       match="test_error_attribution") as info:
        bad.compute()
    assert isinstance(info.value.__cause__, IndexError)


@pytest.mark.parametrize("cg", [tcg, jcg], ids=["torch", "jax"])
def test_reduction_into_live_stream_fails_loudly(cg):
    """mean(x) - x over one generator: the fold consumes the stream, and
    the rest of the expression must fail, not return partial data."""
    node = cg.StreamNode(iter([np.arange(4.0), np.arange(6.0)]))
    centered = np.mean(node) - node
    with pytest.raises(cg.ComputationException, match="empty stream"):
        cg.compute(centered)


def test_reduction_feeding_math_autocomputes():
    def run(cg):
        a = cg.StreamNode(iter([np.arange(4.0), np.arange(8.0)]))
        b = cg.StreamNode(iter([np.ones(3), 2 * np.ones(5)]))
        return np.sqrt(np.mean(a)), np.mean(
            cg.StreamNode(iter([np.arange(4.0)]))) + np.sum(b)
    got, want = run(tcg), run(jcg)
    assert not isinstance(got[0], tcg.Node)
    assert_same(got, want)


@pytest.mark.parametrize("build", ["fold", "map"])
def test_empty_stream_raises(build):
    def run(cg):
        node = cg.StreamNode(iter([]))
        expr = np.sum(node) if build == "fold" else node + 1
        with pytest.raises(cg.ComputationException, match="empty stream"):
            cg.compute(expr)
    run(tcg)
    run(jcg)


def test_get_iter_yields_chunk_values():
    def run(cg):
        node = cg.StreamNode(iter(_chunks(4)))
        return list((node * 2).get_iter())
    got, want = run(tcg), run(jcg)
    assert_same(got, want)
    with pytest.raises(tcg.ComputationException, match="per-chunk"):
        list(np.sum(tcg.StreamNode(iter([np.arange(2)]))).get_iter())


def test_histogram_edges_must_agree():
    def run(cg):
        node = cg.StreamNode(iter([np.arange(3.0), np.arange(5.0)]))
        return cg.ReductionNode(cg.ComputationNode(
            lambda x: np.histogram(x, bins=len(x)), [node]), cg.HISTOGRAM)
    for cg in (tcg, jcg):
        with pytest.raises(cg.ComputationException, match="bin edges"):
            run(cg).compute()


@pytest.mark.parametrize("axis", [1, -2])
def test_invalid_axes_raise(axis):
    node = tcg.StreamNode(iter([np.arange(3)]))
    with pytest.raises(ValueError):
        node.max(axis=axis)
    with pytest.raises(ValueError):
        node.var(axis=axis)


def test_constants_pass_through_compute():
    assert tcg.compute(5) == jcg.compute(5) == 5
    node = tcg.StreamNode(iter([np.arange(2)]))
    assert tcg.compute({"a": "x", "n": np.sum(node)})["a"] == "x"


# -- folds over torch partials ------------------------------------------------

def _torch_partials(seed, dtype=torch.int64):
    return [torch.as_tensor(c, dtype=dtype) for c in _chunks(seed)]


def _jax_partials(seed):
    return [jnp.asarray(c) for c in _chunks(seed)]


def _to_host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tensor_equal(got, want, dtype=torch.int64):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == dtype
    np.testing.assert_array_equal(_to_host(got), _to_host(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fold", ["SUM", "MAX", "MIN"])
def test_elementwise_fold_of_torch_partials(fold, seed):
    """Same-shape partials (the first 1-row chunk's length cut to all)
    folded element by element: the state stays a tensor on its device."""
    n = 1
    t_chunks = [c[:n] for c in _torch_partials(seed)]
    j_chunks = [c[:n] for c in _jax_partials(seed)]
    got = tcg.ReductionNode(tcg.StreamNode(iter(t_chunks)),
                            getattr(tcg, fold)).compute()
    want = jcg.ReductionNode(jcg.StreamNode(iter(j_chunks)),
                             getattr(jcg, fold)).compute()
    _assert_tensor_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["sum", "max", "min", "bincount",
                                  "quantile"])
def test_numpy_protocol_folds_of_torch_chunks(case, seed):
    """np.sum / np.max / np.min / np.bincount / np.quantile over a node of
    torch chunks run as torch ops and fold to a tensor equal to JAX's over
    the same chunks."""
    build = {"sum": np.sum, "max": np.max, "min": np.min,
             "bincount": np.bincount,
             "quantile": lambda n: np.quantile(n, [0.25, 0.5, 1.0])}[case]
    got = tcg.compute(build(tcg.StreamNode(iter(_torch_partials(seed)))))
    j_chunks = _chunks(seed) if case == "bincount" else _jax_partials(seed)
    want = jcg.compute(build(jcg.StreamNode(iter(j_chunks))))
    _assert_tensor_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_bincount_fold_of_torch_partials_pads(seed):
    """BINCOUNT's pad-add over tensor partials of different lengths."""
    t_parts = [torch.bincount(c) for c in _torch_partials(seed)]
    got = tcg.ReductionNode(tcg.StreamNode(iter(t_parts)),
                            tcg.Reduction(tcg.BINCOUNT.combine)).compute()
    want = jcg.ReductionNode(
        jcg.StreamNode(iter([np.bincount(c) for c in _chunks(seed)])),
        jcg.Reduction(jcg.BINCOUNT.combine)).compute()
    _assert_tensor_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_moments_of_torch_chunks(seed):
    """mean, var and std of integer-valued float64 chunks: the sums are
    exact in any order, so the tensor folds equal JAX's numpy folds."""
    host = [c.astype(np.float64) for c in _chunks(seed)]

    def nodes(cg, chunks):
        return [f(cg.StreamNode(iter(chunks)))
                for f in (np.mean, np.var, np.std)]
    got = tcg.compute(nodes(tcg, [torch.from_numpy(c) for c in host]))
    want = jcg.compute(nodes(jcg, host))
    for g, w in zip(got, want):
        _assert_tensor_equal(g, w, torch.float64)


@pytest.mark.parametrize("seed", SEEDS)
def test_column_mean_of_torch_chunks(seed):
    """np.mean(axis=0) of 2-D tensor chunks: per-column (sum, n) folded
    on the chunks' device, equal to JAX's numpy fold."""
    host = [c.astype(np.float64) for c in _chunks(seed, "2d")]
    got = tcg.compute(np.mean(tcg.StreamNode(iter(
        [torch.from_numpy(c) for c in host])), axis=0))
    want = jcg.compute(np.mean(jcg.StreamNode(iter(host)), axis=0))
    _assert_tensor_equal(got, want, torch.float64)


@pytest.mark.parametrize("case", ["arith", "reflected", "compare", "neg-abs",
                                  "mod-pow"])
def test_operators_on_torch_chunks_stay_tensors(case):
    """A node's Python operators map tensor chunks by the same operators
    (torch ops on the chunks' device); the map root concatenates them
    with torch.cat, equal to JAX's numpy result."""
    build = {"arith": lambda n: n * 3 + 1 - n // 2,
             "reflected": lambda n: 100 - 2 * n,
             "compare": lambda n: (n > 20) & (n <= 50) | (n == 7),
             "neg-abs": lambda n: abs(-n + 30),
             "mod-pow": lambda n: (n % 7) ** 2}[case]
    got = tcg.compute(build(tcg.StreamNode(iter(_torch_partials(5)))))
    want = jcg.compute(build(jcg.StreamNode(iter(_chunks(5)))))
    dtype = torch.bool if case == "compare" else torch.int64
    _assert_tensor_equal(got, want, dtype)


@pytest.mark.parametrize("seed", SEEDS)
def test_binned_pileup_fold_stays_a_tensor(seed):
    """The counterpart of the JAX package's on-device fold: per-chunk
    binned pileups (ops/tracks) summed by SUM stay one torch tensor on the
    partials' device and equal JAX's fold of its binned_pileup partials
    and a numpy recount."""
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(4):
        starts = rng.integers(0, 950, 30)
        chunks.append((starts, starts + rng.integers(1, 50, 30)))

    def torch_bins(chunk):
        starts, stops = (torch.from_numpy(a.astype(np.int32)) for a in chunk)
        return torch_binned_pileup(starts, stops,
                                   torch.ones(len(starts), dtype=torch.bool),
                                   100, 10)

    def jax_bins(chunk):
        starts, stops = (jnp.asarray(a.astype(np.int32)) for a in chunk)
        return jax_binned_pileup(starts, stops,
                                 jnp.ones(len(starts), bool), 100, 10)

    got = tcg.ReductionNode(tcg.ComputationNode(
        torch_bins, [tcg.StreamNode(iter(chunks))]), tcg.SUM).compute()
    want = jcg.ReductionNode(jcg.ComputationNode(
        jax_bins, [jcg.StreamNode(iter(chunks))]), jcg.SUM).compute()
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    depth = np.zeros(1000, np.int64)
    for starts, stops in chunks:
        for s, e in zip(starts, stops):
            depth[s:e] += 1
    np.testing.assert_array_equal(got.numpy(),
                                  depth.reshape(100, 10).sum(axis=1))
