"""The port's stream layer (streams/: the reductions, chunk_entries,
groupby, chromosome_map, left_join, MultiStream and its kin, the memory
mapping) against the JAX package's, on the CPU: the same seeded chunks
through both, results array-equal with their dtypes.  Floats are
compared with ==: both packages fold the same numpy calls in the same
order."""
import os

import numpy as np
import pytest

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu import streams as jstreams
from bionumpy_tpu.streams import groupby_func as jgroupby
from bionumpy_tpu.streams import memory_mapping as jmm
from bionumpy_tpu_torch import streams as tstreams
from bionumpy_tpu_torch.streams import groupby_func as tgroupby
from bionumpy_tpu_torch.streams import memory_mapping as tmm

PACKAGES = {"jax": (jbnp, jstreams), "torch": (tbnp, tstreams)}
SEEDS = [0, 1, 2]


def assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert type(got) is type(want)
        assert got == want


def columns(records):
    """A record batch as {field: host values}: strings as str lists,
    numbers as arrays (dtype kept)."""
    out = {}
    for name in records.__class__.__dataclass_fields__:
        col = getattr(records, name)
        if hasattr(col, "tolist") and not isinstance(col, np.ndarray):
            out[name] = [str(x) for x in col.tolist()]
        else:
            out[name] = np.asarray(col)
    return out


def assert_same_records(got, want):
    assert len(got) == len(want)
    a, b = columns(got), columns(want)
    assert a.keys() == b.keys()
    for name in a:
        assert_same(a[name], b[name])


def _chunks(seed, n_chunks=5, dtype=np.int64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 40, rng.integers(0, 300)).astype(dtype)
            for _ in range(n_chunks)]


def _both(fn):
    """fn(bnp, streams) for each package: (port's, JAX's)."""
    return fn(*PACKAGES["torch"]), fn(*PACKAGES["jax"])


# -- reductions ----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_bincount_stream_and_array(seed):
    chunks = _chunks(seed)
    got, want = _both(lambda bnp, s: bnp.bincount(s.BnpStream(iter(chunks))))
    assert_same(got, want)
    np.testing.assert_array_equal(got, np.bincount(np.concatenate(chunks)))
    got, want = _both(lambda bnp, s: s.bincount(chunks[0]))
    assert_same(got, want)
    assert_same(tstreams.reductions.bincount_reduce(
        np.array([1, 2]), np.array([5, 5, 5])),
        jstreams.reductions.bincount_reduce(np.array([1, 2]),
                                            np.array([5, 5, 5])))


@pytest.mark.parametrize("seed", SEEDS)
def test_histogram_stream(seed):
    chunks = [c.astype(np.float64) / 3 for c in _chunks(seed)]
    bins = np.linspace(0, 14, 8)
    got, want = _both(lambda bnp, s: bnp.histogram(
        s.BnpStream(iter(chunks)), bins=bins))
    assert_same(got, want)
    assert_same(got, np.histogram(np.concatenate(chunks), bins=bins))


@pytest.mark.parametrize("seed", SEEDS)
def test_mean_stream(seed):
    chunks = [c.astype(np.float64) * 0.7 for c in _chunks(seed)]
    got, want = _both(lambda bnp, s: bnp.mean(s.BnpStream(iter(chunks))))
    assert_same(got, want)
    got, want = _both(lambda bnp, s: bnp.mean(chunks[1]))
    assert_same(got, want)
    rng = np.random.default_rng(seed)
    mats = [rng.random((rng.integers(1, 20), 4)) for _ in range(4)]
    got, want = _both(lambda bnp, s: s.mean(s.BnpStream(iter(mats)), axis=0))
    assert_same(got, want)
    got, want = _both(lambda bnp, s: s.mean(s.BnpStream(iter(mats)),
                                            axis=1))
    assert_same(list(got), list(want))
    got, want = _both(lambda bnp, s: s.reductions.sum_and_n(
        s.BnpStream(iter(mats)), axis=0))
    assert_same(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_quantile_stream(seed):
    chunks = _chunks(seed)
    q = [0.0, 0.1, 0.5, 0.9, 1.0]
    got, want = _both(lambda bnp, s: bnp.quantile(s.BnpStream(iter(chunks)),
                                                  q))
    assert_same(got, want)
    got, want = _both(lambda bnp, s: bnp.quantile(chunks[0], 0.5))
    assert_same(got, want)


# -- chunk_entries, groupby, chromosome_map, left_join ---------------------------

def _interval_chunks(bnp, seed, names=("chr1", "chr2", "chr3", "chr5")):
    """Sorted seeded intervals over `names`, cut into chunks whose edges
    fall inside chromosomes."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 12, len(names))
    chroms = np.repeat(names, counts).tolist()
    starts = np.sort(rng.integers(0, 1000, len(chroms)))
    stops = starts + rng.integers(1, 50, len(chroms))
    cuts = np.sort(rng.integers(0, len(chroms) + 1, 3))
    bounds = [0, *cuts.tolist(), len(chroms)]
    return [bnp.datatypes.Interval(chroms[a:b], starts[a:b], stops[a:b])
            for a, b in zip(bounds[:-1], bounds[1:])]


@pytest.mark.parametrize("n_entries", [1, 4, 7, 100])
def test_chunk_entries(n_entries):
    def run(bnp, s):
        stream = s.NpDataclassStream(iter(_interval_chunks(bnp, 3)),
                                     dataclass=bnp.datatypes.Interval)
        return list(s.chunk_entries(stream, n_entries))
    got, want = _both(run)
    assert [len(c) for c in got] == [len(c) for c in want]
    for a, b in zip(got, want):
        assert_same_records(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_groupby_across_chunks(seed):
    def run(bnp, s):
        stream = s.NpDataclassStream(iter(_interval_chunks(bnp, seed)),
                                     dataclass=bnp.datatypes.Interval)
        return list(bnp.groupby(stream, "chromosome"))
    got, want = _both(run)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert_same_records(a, b)

    def whole(bnp, s):
        chunks = _interval_chunks(bnp, seed)
        data = np.concatenate(chunks)
        return list(s.groupby(data, "chromosome"))
    got, want = _both(whole)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert_same_records(a, b)


def test_groupby_plain_keys_and_empty():
    keys = np.array([3, 3, 1, 1, 1, 7, 3])
    got, want = _both(lambda bnp, s: [(k, v.tolist())
                                      for k, v in s.groupby(keys)])
    assert got == want == [("3", [3, 3]), ("1", [1, 1, 1]), ("7", [7]),
                           ("3", [3])]
    got, want = _both(lambda bnp, s: list(s.groupby(np.empty(0, int))))
    assert got == want == []
    got, want = _both(lambda bnp, s: [
        (k, len(v)) for k, v in s.groupby(np.array([[1, 2], [1, 2], [2, 1]]),
                                          key=lambda x: str(x.tolist()))])
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_get_changes_of_every_key_kind(seed):
    rng = np.random.default_rng(seed)
    words = ["A", "AC", "AC", "G", "G", "G", "ACG", "ACG", "T"]
    words = [words[i] for i in np.sort(rng.integers(0, len(words), 20))]

    def run(bnp, s):
        mod = s.groupby_func
        out = [mod.get_changes(bnp.as_encoded_array(words))]
        out.append(mod.get_changes(bnp.as_string_array(words)))
        out.append(mod.get_changes(bnp.encodings.string_encodings
                                   .StringEncoding(sorted(set(words)))
                                   .encode(words)))
        ragged = bnp.ragged.RaggedArray(
            rng.integers(0, 2, 30), [3, 3, 3, 2, 4, 4, 0, 0, 5, 6])
        out.append(mod.get_ragged_changes(ragged))
        out.append(mod.get_ragged_changes(bnp.ragged.RaggedArray([1], [1])))
        out.append(mod._within_row(np.array([2, 0, 3])))
        out.append(mod._within_row(np.array([0, 0])))
        return out
    rng = np.random.default_rng(seed)
    got = run(tbnp, tstreams)
    rng = np.random.default_rng(seed)
    want = run(jbnp, jstreams)
    for a, b in zip(got, want):
        assert_same(a, b)


def test_key_func():
    for value in (np.int64(3), "chr1", np.array([1, 2])):
        assert tgroupby.key_func(value) == jgroupby.key_func(value)
    for bnp, mod in ((tbnp, tgroupby), (jbnp, jgroupby)):
        assert mod.key_func(bnp.as_encoded_array("ACG")) == "ACG"


@pytest.mark.parametrize("reduction", [None, sum])
def test_chromosome_map_over_streams_and_dicts(reduction):
    data = {"chr1": np.arange(5), "chr2": np.arange(3) * 2,
            "chr3": np.ones(4, int)}
    weights = {"chr1": 2, "chr2": 3, "chr3": 5}

    def run(bnp, s):
        @s.chromosome_map(reduction)
        def weighted(values, weight, offset=0):
            return int(values.sum()) * weight + offset

        @s.grouped_dict("chromosome")
        class Weights(dict):
            pass

        stream = s.grouped_stream(iter(data.items()))
        out = weighted(stream, Weights(weights), offset=1)
        out = out if reduction else list(out)
        kw = weighted(values=s.grouped_stream(iter(data.items())),
                      weight=Weights(weights))
        kw = kw if reduction else list(kw)
        dicts = weighted(Weights(data), 10)
        plain = weighted(np.arange(4), 3)
        return out, kw, dicts, plain
    got, want = _both(run)
    assert got == want
    assert got[3] == 18


def test_left_join():
    left = [("chr1", 1), ("chr2", 2), ("chr3", 3)]
    right = [("chr1", "a"), ("chr3", "c")]
    got, want = _both(lambda bnp, s: list(s.left_join(iter(left),
                                                      iter(right))))
    assert got == want == [("chr1", 1, "a"), ("chr2", 2, None),
                           ("chr3", 3, "c")]
    for s in (tstreams, jstreams):
        with pytest.raises(ValueError, match="Data left in right group"):
            list(s.left_join(iter(left[:1]), iter(right)))


# -- MultiStream -----------------------------------------------------------------

SIZES = {"chr1": 1000, "chr2": 800, "chr3": 1200, "chr4": 50, "chr5": 900}


@pytest.mark.parametrize("seed", SEEDS)
def test_multistream_synchronises_streams_and_dicts(seed):
    def run(bnp, s):
        stream = s.NpDataclassStream(iter(_interval_chunks(bnp, seed)),
                                     dataclass=bnp.datatypes.Interval)
        lookup = {name: size * 2 for name, size in SIZES.items()}
        ms = bnp.MultiStream(SIZES, a=stream, b=lookup)
        return (list(ms.lengths), list(ms.sequence_names), list(ms.a),
                list(ms.b))
    got, want = _both(run)
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    assert len(got[2]) == len(want[2]) == len(SIZES)
    for a, b in zip(got[2], want[2]):
        assert_same_records(a, b)


def test_multistream_from_records_and_chromosome_sizes():
    def run(bnp, s):
        sizes = bnp.datatypes.ChromosomeSize(["chr1", "chr2", "chr3"],
                                             [10, 20, 30])
        iv = bnp.datatypes.Interval(["chr1", "chr3", "chr3"], [0, 1, 5],
                                    [5, 4, 9])
        ms = bnp.MultiStream(sizes, intervals=iv)
        ms.set_defaults(intervals=None)
        groups = list(ms.intervals)
        return list(ms.lengths), [None if g is None else columns(g)
                                  for g in groups]
    got, want = _both(run)
    assert got[0] == want[0] == [10, 20, 30]
    assert got[1][1] is None and want[1][1] is None
    for a, b in zip(got[1], want[1]):
        if a is not None:
            assert a.keys() == b.keys()
            for name in a:
                assert_same(a[name], b[name])


def test_multistream_key_functions_and_errors():
    def run(bnp, s):
        iv = bnp.datatypes.Interval(["1", "3"], [0, 1], [5, 4])
        stream = s.NpDataclassStream(iter([iv]),
                                     dataclass=bnp.datatypes.Interval)
        ms = bnp.MultiStream({"chr1": 10, "chr2": 20, "chr3": 30}, a=stream)
        ms.set_key_functions(a=lambda name: "chr" + name)
        return [len(g) for g in ms.a]
    assert _both(run) == ([1, 0, 1], [1, 0, 1])
    for bnp, s in (PACKAGES["torch"], PACKAGES["jax"]):
        iv = bnp.datatypes.Interval(["chr2", "chr1"], [0, 1], [5, 4])
        ms = bnp.MultiStream({"chr1": 10, "chr2": 20}, a=s.NpDataclassStream(
            iter([iv]), dataclass=bnp.datatypes.Interval))
        with pytest.raises(s.StreamError, match="sort-order"):
            list(ms.a)
        iv = bnp.datatypes.Interval(["chrX"], [0], [5])
        ms = bnp.MultiStream({"chr1": 10}, a=s.NpDataclassStream(
            iter([iv]), dataclass=bnp.datatypes.Interval))
        with pytest.raises(s.StreamError, match="not in the contig"):
            list(ms.a)
        synched = s.SynchedStream(s.NpDataclassStream(
            iter([]), dataclass=bnp.datatypes.Interval), ["chr1"])
        synched._has_default = False
        with pytest.raises(s.StreamError, match="no default"):
            list(synched)
        with pytest.raises(TypeError, match="dict or ChromosomeSize"):
            bnp.MultiStream([("chr1", 10)])
        with pytest.raises(ValueError, match="only streams and dict-likes"):
            bnp.MultiStream({"chr1": 10}, a=5)


def test_indexed_stream_and_key_helpers():
    names = ["chr10", "chr2", "chrX", "chr1_random", "chr1", "chrM"]
    for s in (tstreams, jstreams):
        idx = s.IndexedStream({"a": 1, "b": 2}, ["b", "a"])
        assert list(idx) == [2, 1]
        assert "IndexedStream" in repr(idx)
        synched = s.SynchedStream(s.BnpStream(iter([])), ["chr1"])
        assert repr(synched) == str(synched) == "SynchedStream over ['chr1']"
        assert isinstance(s.SequenceSizes(a=1), dict)
    mt, mj = tstreams.multistream, jstreams.multistream
    assert sorted(names, key=mt.human_key_func) == \
        sorted(names, key=mj.human_key_func)
    assert list(mt.sort_dict_by_key(dict.fromkeys(names, 0),
                                    mt.human_key_func)) == \
        list(mj.sort_dict_by_key(dict.fromkeys(names, 0), mj.human_key_func))
    assert tbnp.MultiStream.human_key_func("chr7") == \
        jbnp.MultiStream.human_key_func("chr7")


# -- memory mapping ---------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_memmap_written_by_each_package_is_the_same_bytes(seed, tmp_path):
    """Each package writes the same chunks; the .dat files are equal
    byte for byte, and each package loads its own files (the encoding
    is a pickle of the package's own class) to the same arrays."""
    rng = np.random.default_rng(seed)
    chunks = [["".join(rng.choice(list("ACGT"), rng.integers(0, 30)))
               for _ in range(rng.integers(1, 40))] for _ in range(3)]
    loaded = {}
    for tag, (bnp, mm) in {"torch": (tbnp, tmm), "jax": (jbnp, jmm)}.items():
        base = str(tmp_path / tag)

        def loader():
            return iter(bnp.as_encoded_array(c, bnp.DNAEncoding)
                        for c in chunks)
        made = mm.MemMapEncodedRaggedArray.create(loader, base)
        back = mm.MemMapEncodedRaggedArray.load(base)
        for arr in (made, back):
            assert arr.tolist() == [s for c in chunks for s in c]
        loaded[tag] = back
    for suffix in ("_data.dat", "_lengths.dat"):
        with open(str(tmp_path / "torch") + suffix, "rb") as a, \
                open(str(tmp_path / "jax") + suffix, "rb") as b:
            assert a.read() == b.read()
    t, j = loaded["torch"], loaded["jax"]
    assert_same(np.asarray(t.ravel().raw()), np.asarray(j.ravel().raw()))
    assert_same(np.asarray(t.lengths), np.asarray(j.lengths))
    assert repr(t.encoding) == repr(j.encoding)
    assert os.path.getsize(str(tmp_path / "torch") + "_encoding.pkl") > 0
