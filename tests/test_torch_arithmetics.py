"""The port's interval arithmetic (arithmetics/: intervals, bedgraph,
similarity_measures), genomic_data.GlobalOffset and
pipeline.binned_pileup_bed against the JAX package's, on the CPU: the
same seeded intervals and BED files through both (the JAX side on its
CPU devices, the port's device calls with device="cpu"), results
array-equal with their dtypes.  jaccard and forbes return floats made
from integer tables in the same order in both packages, so they are
compared with ==."""
import gzip
import types

import numpy as np
import pytest

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu import arithmetics as jar
from bionumpy_tpu import pipeline as jpipe
from bionumpy_tpu.arithmetics import bedgraph as jbg
from bionumpy_tpu.genomic_data.global_offset import GlobalOffset as JOffset
from bionumpy_tpu_torch import arithmetics as tar
from bionumpy_tpu_torch import pipeline as tpipe
from bionumpy_tpu_torch.arithmetics import bedgraph as tbg
from bionumpy_tpu_torch.genomic_data import GlobalOffset as TOffset

SEEDS = [0, 1, 2]
SIZES = {"chr1": 5000, "chr2": 3100, "chr3": 900, "chr4": 2500}


def assert_same(got, want):
    """Equal values of the same type and dtype: RLEs by events and
    values, record batches column by column, arrays with dtype."""
    if isinstance(want, jbnp.ragged.rle.RunLengthArray):
        assert type(got).__name__ == type(want).__name__
        for a, b in ((got.events, want.events), (got.values, want.values)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    elif hasattr(want, "__dataclass_fields__"):
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want)
        for name in want.__class__.__dataclass_fields__:
            assert_same(_host(getattr(got, name)), _host(getattr(want, name)))
    elif isinstance(want, (tuple, list)):
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


def _host(col):
    if hasattr(col, "tolist") and not isinstance(col, np.ndarray):
        return [str(x) for x in col.tolist()]
    return np.asarray(col)


def _iv(bnp, seed, n=60, size=1000, chrom="chr1", sort=True, cls=None):
    """Seeded intervals on one chromosome: overlapping, nested, touching
    and one-base ones, sorted on start unless `sort` is False."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, size - 60, n)
    stops = starts + rng.integers(1, 60, n)
    stops[:3] = starts[:3] + 1
    if n > 6:
        starts[5], stops[5] = stops[4], stops[4] + 10
    if sort:
        order = np.argsort(starts, kind="stable")
        starts, stops = starts[order], stops[order]
    if cls == "Bed6":
        strand = np.where(rng.random(n) < 0.5, "+", "-").tolist()
        return bnp.datatypes.Bed6([chrom] * n, starts, stops, ["x"] * n,
                                  np.zeros(n, int), strand)
    return bnp.datatypes.Interval([chrom] * n, starts, stops)


def _both(fn):
    return fn(tbnp, tar), fn(jbnp, jar)


# -- GenomicRunLengthArray -------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_genomic_rle_constructors(seed):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.choice(np.arange(1, 999), 20, replace=False))
    starts, ends = edges[0::2], edges[1::2]
    values = rng.integers(1, 9, len(starts))
    for vals, default in ((True, False), (3, 0), (2.5, -1.0), (values, 0)):
        got, want = _both(lambda bnp, ar: ar.GenomicRunLengthArray
                          .from_intervals(starts, ends, 1000, vals, default))
        assert_same(got, want)
    got, want = _both(lambda bnp, ar: ar.GenomicRunLengthArray.from_rle(
        ar.GenomicRunLengthArray.from_intervals(starts, ends, 1000)))
    assert_same(got, want)
    got, want = _both(lambda bnp, ar: ar.GenomicRunLengthArray
                      .from_intervals(starts, ends, 1000, values)
                      .to_bedgraph("chr7"))
    assert_same(got, want)


@pytest.mark.parametrize("size", [None, 1000, 1200])
def test_genomic_rle_from_bedgraph(size):
    def run(bnp, ar):
        bg = bnp.datatypes.BedGraph(["c"] * 4, [5, 20, 30, 60],
                                    [20, 25, 50, 1000], [1.5, 2.0, 0.5, 3.0])
        return ar.GenomicRunLengthArray.from_bedgraph(bg, size)
    assert_same(*_both(run))
    got, want = _both(lambda bnp, ar: ar.GenomicRunLengthArray.from_bedgraph(
        bnp.datatypes.BedGraph([], [], [], []), 50))
    assert_same(got, want)


# -- pileups and masks -------------------------------------------------------------

def _dense_depth(iv, size):
    depth = np.zeros(size, np.int64)
    for s, e in zip(np.asarray(iv.start), np.asarray(iv.stop)):
        depth[s:e] += 1
    return depth


@pytest.mark.parametrize("seed", SEEDS)
def test_get_pileup(seed):
    got, want = _both(lambda bnp, ar: ar.get_pileup(
        _iv(bnp, seed, sort=False), 1000))
    assert_same(got, want)
    np.testing.assert_array_equal(got.to_array(),
                                  _dense_depth(_iv(tbnp, seed), 1000))
    got, want = _both(lambda bnp, ar: ar.get_pileup(
        bnp.datatypes.Interval([], [], []), 77))
    assert_same(got, want)
    got, want = _both(lambda bnp, ar: tbg.get_pileup(
        _iv(bnp, seed), 1000) if bnp is tbnp else jbg.get_pileup(
        _iv(bnp, seed), 1000))
    assert_same(got, want)


@pytest.mark.parametrize("bin_size", [None, 1, 7, 100, 1000, 4096])
@pytest.mark.parametrize("seed", SEEDS)
def test_get_pileup_device(seed, bin_size):
    """The port's device pileup on device="cpu" against JAX's on its CPU
    device: dense (an RLE of int32 depths) or binned (int32 bins)."""
    def run(bnp, ar):
        kw = {"device": "cpu"} if bnp is tbnp else {}
        return ar.get_pileup_device(_iv(bnp, seed, sort=False), 1000,
                                    bin_size=bin_size, **kw)
    got, want = _both(run)
    assert_same(got, want)
    if bin_size is None:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got.to_array(),
                                      _dense_depth(_iv(tbnp, seed), 1000))
    else:
        n_bins = -(-1000 // bin_size)
        depth = np.concatenate([_dense_depth(_iv(tbnp, seed), 1000),
                                np.zeros(n_bins * bin_size - 1000, int)])
        np.testing.assert_array_equal(
            got, depth.reshape(n_bins, bin_size).sum(axis=1))


def test_get_pileup_device_empty_and_the_card():
    for bin_size in (None, 10):
        got, want = _both(lambda bnp, ar: ar.get_pileup_device(
            bnp.datatypes.Interval([], [], []), 35, bin_size,
            **({"device": "cpu"} if bnp is tbnp else {})))
        assert_same(got, want)
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tar.get_pileup_device(_iv(tbnp, 0), 1000)


@pytest.mark.parametrize("seed", SEEDS)
def test_get_boolean_mask(seed):
    got, want = _both(lambda bnp, ar: ar.get_boolean_mask(
        _iv(bnp, seed, sort=False), 1000))
    assert_same(got, want)
    np.testing.assert_array_equal(got.to_array(),
                                  _dense_depth(_iv(tbnp, seed), 1000) > 0)
    got, want = _both(lambda bnp, ar: ar.get_boolean_mask(
        bnp.datatypes.Interval([], [], []), 40))
    assert_same(got, want)
    got, want = _both(lambda bnp, ar: ~ar.get_boolean_mask(
        _iv(bnp, seed), 1000) & ar.get_boolean_mask(_iv(bnp, seed + 5),
                                                    1000))
    assert_same(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_pileup_bedgraph(seed):
    got, want = _both(lambda bnp, ar: ar.intervals.pileup(_iv(bnp, seed)))
    assert_same(got, want)


# -- sorting, merging, intersecting ---------------------------------------------------

def _multi_chrom(bnp, seed, n=50):
    rng = np.random.default_rng(seed)
    names = np.array(["chr2", "chr10", "chr1", "chrX", "chr1_alt"])
    chroms = names[rng.integers(0, len(names), n)].tolist()
    starts = rng.integers(0, 500, n)
    return bnp.datatypes.Interval(chroms, starts,
                                  starts + rng.integers(1, 40, n))


@pytest.mark.parametrize("seed", SEEDS)
def test_sort_intervals(seed):
    order = ["chr1", "chr1_alt", "chr2", "chr10", "chrX"]
    for kw in ({}, {"sort_order": order},
               {"chromosome_key_function": None}):
        def run(bnp, ar):
            if "chromosome_key_function" in kw:
                return ar.sort_intervals(_multi_chrom(bnp, seed),
                                         ar.intervals.human_key_func)
            return ar.sort_intervals(_multi_chrom(bnp, seed), **kw)
        assert_same(*_both(run))

    def encoded(bnp, ar):
        iv = _multi_chrom(bnp, seed)
        enc = bnp.encodings.string_encodings.StringEncoding(order)
        iv = bnp.datatypes.Interval(enc.encode(iv.chromosome.tolist()),
                                    iv.start, iv.stop)
        return ar.sort_intervals(iv), ar.fast_sort_intervals(iv)
    assert_same(*_both(encoded))

    def strings(bnp, ar):
        iv = _multi_chrom(bnp, seed)
        iv = bnp.datatypes.Interval(
            bnp.as_string_array(iv.chromosome.tolist()), iv.start, iv.stop)
        return ar.fast_sort_intervals(iv)
    assert_same(*_both(strings))
    for bnp, ar in ((tbnp, tar), (jbnp, jar)):
        ragged_names = types.SimpleNamespace(
            chromosome=bnp.as_encoded_array(["chr1", "chr2"]), start=[0, 1])
        with pytest.raises(ValueError, match="fast_sort_intervals"):
            ar.fast_sort_intervals(ragged_names)


def test_human_key_func():
    names = ["chr10", "chr2", "chrX", "chr1_random", "chr1", "chrM"]
    assert [tar.intervals.human_key_func(n) for n in names] == \
        [jar.intervals.human_key_func(n) for n in names]


@pytest.mark.parametrize("distance", [0, 3, 25])
@pytest.mark.parametrize("seed", SEEDS)
def test_merge_intervals(seed, distance):
    assert_same(*_both(lambda bnp, ar: ar.merge_intervals(
        _iv(bnp, seed), distance=distance)))
    got, want = _both(lambda bnp, ar: ar.merge_intervals(
        bnp.datatypes.Interval([], [], [])))
    assert len(got) == len(want) == 0

    def streamed(bnp, ar):
        chunks = [_iv(bnp, seed + i, chrom=f"chr{i}") for i in range(3)]
        return list(ar.merge_intervals(bnp.streams.NpDataclassStream(
            iter(chunks), dataclass=bnp.datatypes.Interval)))
    assert_same(*_both(streamed))


@pytest.mark.parametrize("seed", SEEDS)
def test_overlaps_and_intersections(seed):
    def run(bnp, ar):
        a, b = _iv(bnp, seed), _iv(bnp, seed + 7, n=30)
        return (ar.count_overlap(a, b), ar.intersect(a, b),
                ar.global_intersect(a, b), ar.unique_intersect(a, b, 1000))
    got, want = _both(run)
    assert_same(got, want)
    assert isinstance(got[0], int)

    def multi(bnp, ar):
        a = ar.sort_intervals(_multi_chrom(bnp, seed))
        b = ar.sort_intervals(_multi_chrom(bnp, seed + 3))
        return ar.global_intersect(a, b)
    assert_same(*_both(multi))


@pytest.mark.parametrize("seed", SEEDS)
def test_extend_clip(seed):
    for kw in ({"both": 5}, {"left": 3}, {"right": 4},
               {"left": 2, "right": 9}, {"forward": 7},
               {"reverse": 2}, {"forward": 3, "reverse": 11}):
        assert_same(*_both(lambda bnp, ar: ar.extend(
            _iv(bnp, seed, cls="Bed6"), **kw)))
    assert_same(*_both(lambda bnp, ar: ar.extend_to_size(
        _iv(bnp, seed, cls="Bed6"), 40, 1000)))
    assert_same(*_both(lambda bnp, ar: ar.clip(
        ar.extend(_iv(bnp, seed), both=30), 1000)))
    for ar, bnp in ((tar, tbnp), (jar, jbnp)):
        with pytest.raises(AssertionError):
            ar.extend(_iv(bnp, seed), both=1, left=1)


# -- bedgraph helpers ------------------------------------------------------------------

def test_bedgraph_helpers():
    parts = [np.arange(5), np.arange(8) * 2, np.ones(3, int)]
    assert_same(tbg.sum_largest(iter(parts)), jbg.sum_largest(iter(parts)))

    def run(bnp, bg):
        graph = bnp.datatypes.BedGraph(["c"] * 3, [0, 10, 15], [10, 15, 40],
                                       [2.0, 0.0, 5.0])
        rle = (tar if bnp is tbnp else jar).get_pileup(_iv(bnp, 2), 1000)
        return bg.value_hist(graph), bg.from_runlength_array("chr9", rle)
    got, want = run(tbnp, tbg), run(jbnp, jbg)
    assert_same(got, want)


# -- similarity over MultiStream -----------------------------------------------------------

def _genome_sets(bnp, ar, seed):
    """Two sorted seeded interval sets over SIZES' chromosomes (chr3
    absent from the second)."""
    rng = np.random.default_rng(seed)
    out = []
    for which, names in enumerate((list(SIZES), ["chr1", "chr2", "chr4"])):
        chroms, starts, stops = [], [], []
        for name in names:
            n = int(rng.integers(0, 40))
            s = rng.integers(0, SIZES[name] - 100, n)
            chroms += [name] * n
            starts.append(s)
            stops.append(s + rng.integers(1, 100, n))
        iv = bnp.datatypes.Interval(chroms, np.concatenate(starts),
                                    np.concatenate(stops))
        out.append(ar.sort_intervals(iv, sort_order=list(SIZES)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_contingency_jaccard_forbes(seed):
    def run(bnp, ar):
        a, b = _genome_sets(bnp, ar, seed)
        table = ar.get_contingency_table(a[a.chromosome == "chr1"],
                                         b[b.chromosome == "chr1"],
                                         SIZES["chr1"])
        return table, ar.jaccard(SIZES, a, b), ar.forbes(SIZES, a, b)
    got, want = _both(run)
    assert_same(got[0], want[0])
    # floats from the same integer tables in the same order: ==, not close
    assert got[1] == want[1] and type(got[1]) is float
    assert got[2] == want[2] and type(got[2]) is float
    a, b = _genome_sets(tbnp, tar, seed)
    mask_a = np.concatenate([
        tar.get_boolean_mask(a[a.chromosome == n], s).to_array()
        for n, s in SIZES.items()])
    mask_b = np.concatenate([
        tar.get_boolean_mask(b[b.chromosome == n], s).to_array()
        for n, s in SIZES.items()])
    both = int(np.sum(mask_a & mask_b))
    assert got[1] == float(both / int(np.sum(mask_a | mask_b)))
    n = mask_a.size
    assert got[2] == float(both * n / (int(mask_a.sum()) * int(mask_b.sum())))


# -- GlobalOffset -------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_global_offset_round_trips(seed):
    rng = np.random.default_rng(seed)
    names = list(SIZES)
    chrom = [names[i] for i in rng.integers(0, len(names), 30)]
    local = np.array([rng.integers(0, SIZES[c]) for c in chrom])

    def run(bnp, cls):
        off = cls(SIZES)
        glob = off.from_local_coordinates(chrom, local)
        back_chrom, back_local = off.to_local_coordinates(glob)
        iv = bnp.datatypes.Interval(chrom, local, np.minimum(
            local + 50, [SIZES[c] for c in chrom]))
        g_iv = off.from_local_interval(iv)
        clipped = off.from_local_interval(
            bnp.datatypes.Interval(chrom, local, local + 10 ** 6),
            do_clip=True)
        return (off.total_size(), off.names(), off.get_offset(chrom),
                off.get_size(chrom), glob, back_chrom.tolist(), back_local,
                g_iv, off.to_local_interval(g_iv), clipped)
    got, want = _both(lambda bnp, ar: run(bnp, TOffset if bnp is tbnp
                                          else JOffset))
    assert_same(got, want)
    assert got[5] == chrom
    np.testing.assert_array_equal(got[6], local)
    for cls in (TOffset, JOffset):
        off = cls(SIZES)
        with pytest.raises(ValueError, match="outside of reference"):
            off.from_local_coordinates(["chr3"], np.array([900]))
    for cls, bnp in ((TOffset, tbnp), (JOffset, jbnp)):
        with pytest.raises(ValueError, match="beyond chromosome size"):
            cls(SIZES).start_ends_from_intervals(
                bnp.datatypes.Interval(["chr3"], [900], [901]))


def test_global_offset_from_chromosome_sizes():
    def run(bnp, ar):
        cls = TOffset if bnp is tbnp else JOffset
        sizes = bnp.datatypes.ChromosomeSize(list(SIZES),
                                             list(SIZES.values()))
        off = cls(sizes)
        return off.total_size(), off.get_offset(["chr2", "chr4"])
    assert_same(*_both(run))


# -- binned_pileup_bed ------------------------------------------------------------------------

def _bed_file(path, seed, sizes, n=400, gz=False, extra=("chrUn",)):
    """A seeded BED file over `sizes` (the last chromosome left empty),
    plus records on chromosomes not in `sizes`."""
    rng = np.random.default_rng(seed)
    names = list(sizes)[:-1]
    lines = []
    for _ in range(n):
        name = names[rng.integers(0, len(names))]
        start = int(rng.integers(0, sizes[name] - 1))
        stop = min(start + int(rng.integers(1, 700)), sizes[name])
        lines.append(f"{name}\t{start}\t{stop}\n")
    for name in extra:
        lines.insert(int(rng.integers(0, len(lines))), f"{name}\t5\t80\n")
    data = "".join(lines).encode()
    if gz:
        data = gzip.compress(data, mtime=0)
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("bin_size", [1, 100, 1000, 3000])
@pytest.mark.parametrize("seed", [0, 1])
def test_binned_pileup_bed(tmp_path, seed, bin_size, gz):
    path = _bed_file(tmp_path / ("a.bed.gz" if gz else "a.bed"), seed, SIZES,
                     gz=gz)
    got, gstats = tpipe.binned_pileup_bed(path, SIZES, bin_size=bin_size,
                                          device="cpu")
    want, wstats = jpipe.binned_pileup_bed(path, SIZES, bin_size=bin_size)
    assert gstats == wstats
    assert list(got) == list(want) == list(SIZES)
    for name in SIZES:
        assert_same(got[name], np.asarray(want[name]))
        assert got[name].dtype == np.int32
    assert not got["chr4"].any()
    bed = tbnp.open(path).read()
    chrom = np.asarray(bed.chromosome.tolist())
    assert gstats["n_intervals"] == int(np.isin(chrom, list(SIZES)).sum())
    for name, size in SIZES.items():
        sel = chrom == name
        depth = np.zeros(-(-size // bin_size) * bin_size, np.int64)
        for s, e in zip(np.asarray(bed.start)[sel], np.asarray(bed.stop)[sel]):
            depth[s:e] += 1
        np.testing.assert_array_equal(got[name],
                                      depth.reshape(-1, bin_size).sum(1))


def test_binned_pileup_bed_only_foreign_records(tmp_path):
    """A file none of whose records lies on `chromosome_sizes` raises in
    both packages alike (the JAX package's empty string column cannot be
    encoded; the port keeps that)."""
    path = tmp_path / "other.bed"
    path.write_text("chrZ\t1\t50\nchrZ\t3\t9\n")
    messages = []
    for run in (lambda: tpipe.binned_pileup_bed(str(path), SIZES, 500,
                                                device="cpu"),
                lambda: jpipe.binned_pileup_bed(str(path), SIZES, 500)):
        with pytest.raises(ValueError, match="cannot reshape") as err:
            run()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_binned_pileup_bed_span_error_mesh_and_card(tmp_path):
    """JAX's int32 span check, with its message, in both; mesh= takes a
    parallel.Mesh; the default device is the card."""
    bed = tmp_path / "a.bed"
    bed.write_text("chrA\t100\t200\n")
    big = {"chrA": 2_500_000_000, "chrB": 2_500_000_000}
    messages = []
    for run in (lambda: tpipe.binned_pileup_bed(str(bed), big, 100,
                                                device="cpu"),
                lambda: jpipe.binned_pileup_bed(str(bed), big, 100)):
        with pytest.raises(ValueError, match="exceeds int32") as err:
            run()
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    with pytest.raises(TypeError, match="Mesh"):
        tpipe.binned_pileup_bed(str(bed), {"chrA": 1000}, mesh=object())
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbnp.binned_pileup_bed(str(bed), {"chrA": 1000})
