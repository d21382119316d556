"""The port's genomic layer (genomic_data/: Genome, GenomeContext,
GenomicIntervals, GenomicLocation, GenomicArray, GenomicSequence,
GenomicAnnotation, BinnedGenome, Geometry, coordinate mapping) against the
JAX package's, on the CPU.  Each case mirrors one of
tests/test_genomic_data.py on seeded FASTA, BED, bedGraph, GTF and
chrom.sizes files written to tmp_path (a FASTA once for each package,
since Genome.from_file writes its .fai beside it), plus Geometry,
StreamedGeometry and the streamed variants.  Results are compared by
value and dtype, exactly: every output is integer, boolean or a float
made from integer tables by the same formula."""
import numpy as np
import pytest

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu.genomic_data import coordinate_mapping as jmap
from bionumpy_tpu.genomic_data import genome_context as jctx
from bionumpy_tpu_torch.genomic_data import coordinate_mapping as tmap
from bionumpy_tpu_torch.genomic_data import genome_context as tctx

SEEDS = [0, 1, 2]
SIZES = {"chr1": 3000, "chr2": 2100, "chr3": 1200, "chr3_alt": 300}
MAIN = {k: v for k, v in SIZES.items() if "_" not in k}
PACKAGES = {"torch": tbnp, "jax": jbnp}


# -- comparing results of the two packages ------------------------------------

def norm(x):
    """A package-free structure of a result: class names, dtypes and
    values, so that two packages' results compare with ==."""
    name = type(x).__name__
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, np.generic):
        return ("np", x.dtype.str, x.item())
    if isinstance(x, (bool, int, float, str)) or x is None:
        return (type(x).__name__, x)
    if name == "RunLengthRaggedArray":
        return (name, [norm(x[i]) for i in range(len(x))])
    if hasattr(x, "events") and hasattr(x, "values") and \
            hasattr(x, "starts"):
        return (name, norm(np.asarray(x.events)), norm(np.asarray(x.values)))
    if hasattr(x, "_global_track"):
        return (name, norm(x._global_track))
    if name in ("GenomicIntervalsFull", "Genes", "Transcripts", "Exons"):
        return (name, x.is_stranded(), norm(x.data))
    if name == "GenomicLocationGlobal":
        return (name, x.is_stranded(), norm(x.data))
    if hasattr(x, "__dataclass_fields__"):
        return (name, {f: norm(getattr(x, f))
                       for f in x.__class__.__dataclass_fields__})
    if name == "StringArray":
        return (name, [str(v) for v in x.tolist()])
    if name == "EncodedRaggedArray":
        return (name, repr(x.encoding), norm(np.asarray(x.ravel().raw())),
                norm(np.asarray(x.lengths)))
    if name == "EncodedArray":
        return (name, repr(x.encoding), norm(np.asarray(x.raw())))
    if name == "RaggedArray":
        return (name, norm(np.asarray(x.ravel())),
                norm(np.asarray(x.lengths)))
    raise TypeError(f"no norm for {name}")


def assert_same(got, want):
    assert norm(got) == norm(want)


def both(fn):
    """fn(bnp) for the port and for the JAX package, compared."""
    got, want = fn(tbnp), fn(jbnp)
    assert_same(got, want)
    return got, want


# -- seeded inputs ------------------------------------------------------------

def seeded_intervals(seed, n=40, sizes=MAIN, stranded=False, width=300):
    """(chromosomes, starts, stops[, strands]) sorted in genome order:
    overlapping and touching intervals, some at a chromosome's ends."""
    rng = np.random.default_rng(seed)
    names = list(sizes)
    chrom_idx = np.sort(rng.integers(0, len(names), n))
    size = np.array([sizes[names[i]] for i in chrom_idx])
    starts = (rng.random(n) * (size - 1)).astype(np.int64)
    stops = np.minimum(starts + rng.integers(1, width, n), size)
    starts[0], stops[-1] = 0, size[-1]
    order = np.lexsort((stops, starts, chrom_idx))
    out = [[names[i] for i in chrom_idx[order]], starts[order], stops[order]]
    if stranded:
        out.append(np.where(rng.random(n) < 0.5, "+", "-")[order].tolist())
    return out


def intervals(bnp, seed, stranded=False, **kw):
    cols = seeded_intervals(seed, stranded=stranded, **kw)
    if stranded:
        return bnp.datatypes.Bed6(cols[0], cols[1], cols[2],
                                  ["x"] * len(cols[1]),
                                  np.zeros(len(cols[1]), int), cols[3])
    return bnp.datatypes.Interval(*cols)


def bedgraph(bnp, seed, sizes=MAIN):
    """Non-overlapping runs with integer values, sorted."""
    rng = np.random.default_rng(seed)
    chroms, starts, stops, values = [], [], [], []
    for name, size in sizes.items():
        edges = np.sort(rng.choice(np.arange(1, size), 9, replace=False))
        s, e = edges[0::2], edges[1::2]
        chroms += [name] * len(e)
        starts += s[: len(e)].tolist()
        stops += e.tolist()
        values += rng.integers(1, 9, len(e)).tolist()
    return bnp.datatypes.BedGraph(chroms, starts, stops, values)


def genome_seq(seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return {name: "".join(rng.choice(list("ACGT"), size))
            for name, size in sizes.items()}


def write_fasta(path, seqs, width=60):
    with open(path, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i: i + width] + "\n")


def write_bed(path, cols):
    with open(path, "w") as f:
        for row in zip(*cols):
            f.write("\t".join(str(v) for v in row[:3]) + "\n")


def write_sizes(path, sizes=SIZES):
    with open(path, "w") as f:
        for name, size in sizes.items():
            f.write(f"{name}\t{size}\n")


def write_gtf(path, seed):
    """Genes with two transcripts of two exons each, per chromosome, in
    genome order."""
    rng = np.random.default_rng(seed)
    lines = []
    for c, (name, size) in enumerate(MAIN.items()):
        for g in range(2):
            start = int(rng.integers(1, size // 2 - 400)) + g * (size // 2)
            gid = f"g{c}.{g}"
            strand = "+-"[int(rng.integers(0, 2))]
            attrs = f'gene_id "{gid}";'
            lines.append((name, "gene", start, start + 399, strand, attrs))
            for t in range(2):
                tid = f"{gid}.t{t}"
                tattrs = f'{attrs} transcript_id "{tid}";'
                lines.append((name, "transcript", start, start + 399,
                              strand, tattrs))
                for e in range(2):
                    es = start + e * 200 + t * 10
                    lines.append((name, "exon", es, es + 149, strand,
                                  f'{tattrs} exon_id "{tid}.e{e}";'))
    with open(path, "w") as f:
        for name, kind, s, e, strand, attrs in lines:
            f.write(f"{name}\tsrc\t{kind}\t{s}\t{e}\t.\t{strand}\t.\t"
                    f"{attrs}\n")


def genome(bnp, sizes=MAIN, **kw):
    return bnp.Genome.from_dict(sizes, **kw)


# -- tracks -------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_get_track(seed):
    def run(bnp):
        track = genome(bnp).get_track(bedgraph(bnp, seed))
        return (track.to_dict(), track.sum(), track.mean(),
                np.max(track), np.min(track), track["chr2"])
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_track_arithmetic(seed):
    def run(bnp):
        track = genome(bnp).get_track(bedgraph(bnp, seed))
        doubled = track * 2
        return (doubled.sum(), (track > 3).to_dict(), (track + track)["chr1"],
                track[track > 3])
    both(run)


@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_track_extraction(seed, stranded):
    def run(bnp):
        track = genome(bnp).get_track(bedgraph(bnp, seed))
        iv = intervals(bnp, seed + 10, stranded=stranded, n=12)
        rows = track.extract_intervals(iv, stranded=stranded)
        by_index = track[genome(bnp).get_intervals(iv, stranded=stranded)]
        return rows, rows.sum(axis=-1), by_index
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_track_locations_and_data(seed):
    def run(bnp):
        g = genome(bnp)
        track = g.get_track(bedgraph(bnp, seed))
        cols = seeded_intervals(seed + 3, n=15)
        locs = g.get_locations(bnp.LocationEntry(cols[0], cols[1]))
        return (track[locs], track.get_data(), (track > 2).get_data(),
                track.to_bedgraph())
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_to_bedgraph_roundtrip(seed):
    def run(bnp):
        g = genome(bnp)
        track = g.get_track(bedgraph(bnp, seed))
        return g.get_track(track.to_bedgraph()).to_dict()
    got, want = both(run)
    assert norm(got) == norm(genome(tbnp).get_track(
        bedgraph(tbnp, seed)).to_dict())


def test_genomic_array_from_dict_global_and_node():
    def run(bnp):
        from_rle = bnp.arithmetics.GenomicRunLengthArray.from_array
        d = {"chr1": from_rle(np.arange(20, dtype=float)),
             "chr2": from_rle(np.repeat([1, 0, 3], [2, 5, 3]))}
        gd = bnp.genomic_data
        node = gd.GenomicArrayNode.from_dict(d)
        glob = gd.GenomicArrayGlobal.from_dict(d)
        stream = gd.GenomicArrayNode.from_stream(iter(d.items()),
                                                 glob.genome_context)
        return (node.compute().to_dict(), glob.to_dict(), glob["chr2"],
                bnp.compute(np.sum(stream)))
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_read_track_stream_matches_full(seed, tmp_path):
    path = tmp_path / "track.bdg"
    bg = bedgraph(jbnp, seed)
    with jbnp.open(str(path), "w") as f:
        f.write(bg)

    def run(bnp):
        g = genome(bnp)
        full = g.read_track(str(path))
        streamed = g.read_track(str(path), stream=True)
        out = bnp.compute({"sum": np.sum(streamed * 2),
                           "max": np.max(g.read_track(str(path),
                                                      stream=True))})
        return (full.to_dict(), np.sum(full), out["sum"], out["max"],
                g.read_track(str(path), stream=True).compute().to_dict())
    got, _ = both(run)
    assert norm(got[0]) == norm(got[4])


# -- intervals ----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_pileup_and_mask(seed):
    def run(bnp):
        gi = genome(bnp).get_intervals(intervals(bnp, seed))
        return gi.get_pileup().to_dict(), gi.get_mask().to_dict(), len(gi)
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_streamed_pileup_and_mask_match_full(seed):
    def run(bnp):
        gi = genome(bnp).get_intervals(intervals(bnp, seed))
        return (gi.as_stream().get_pileup().compute().to_dict(),
                gi.as_stream().get_mask().compute().to_dict(),
                gi.get_pileup().to_dict())
    got, _ = both(run)
    assert norm(got[0]) == norm(got[2])


@pytest.mark.parametrize("seed", SEEDS)
def test_interval_ops(seed):
    def run(bnp):
        gi = genome(bnp).get_intervals(intervals(bnp, seed))
        stranded = genome(bnp).get_intervals(
            intervals(bnp, seed, stranded=True), stranded=True)
        return (gi.merged(), gi.sorted(), gi.clip(),
                stranded.extended_to_size(250),
                gi[np.arange(len(gi)) % 2 == 0], np.concatenate([gi, gi]))
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_streamed_interval_ops(seed):
    def run(bnp):
        gi = genome(bnp).get_intervals(intervals(bnp, seed))
        stranded = genome(bnp).get_intervals(
            intervals(bnp, seed, stranded=True), stranded=True)
        out = [gi.as_stream().merged().compute(),
               gi.as_stream().sorted().compute(),
               gi.as_stream().clip().compute(),
               stranded.as_stream().extended_to_size(250).compute()]
        out.append(bnp.compute(gi.as_stream().start))
        return out
    both(run)


@pytest.mark.parametrize("where", ["start", "stop", "center"])
@pytest.mark.parametrize("stranded", [False, True])
def test_get_location(where, stranded):
    def run(bnp):
        gi = genome(bnp).get_intervals(intervals(bnp, 4, stranded=stranded),
                                       stranded=stranded)
        return gi.get_location(where)
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_locations_and_windows(seed):
    def run(bnp):
        cols = seeded_intervals(seed, n=20)
        locs = genome(bnp).get_locations(bnp.LocationEntry(cols[0], cols[1]))
        return (locs.get_windows(flank=4), locs.get_windows(window_size=7),
                locs.sorted(), locs[3:9])
    both(run)


def test_stranded_locations_from_fields():
    def run(bnp):
        ctx = bnp.genomic_data.GenomeContext.from_dict(SIZES)
        locs = bnp.genomic_data.GenomicLocation.from_fields(
            ctx, ["chr1", "chr2", "chr3_alt"], [5, 2099, 3], ["+", "-", "+"])
        return locs, locs.get_windows(flank=3), locs.strand
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_streamed_locations_windows_and_compute(seed):
    def run(bnp):
        gi = genome(bnp).get_intervals(intervals(bnp, seed))
        loc = gi.as_stream().get_location("start")
        assert type(loc).__name__ == "GenomicLocationStreamed"
        windows = gi.as_stream().get_location("start").get_windows(flank=2)
        return (windows.compute(), loc.compute(),
                gi.get_location("start").get_windows(flank=2))
    got, _ = both(run)
    assert norm(got[0].data) == norm(got[2].data)


def test_get_sorted_stream():
    def run(bnp):
        iv = bnp.datatypes.Interval(["chr2", "chr1", "chr1", "chr3"],
                                    [0, 10, 0, 4], [5, 15, 5, 9])
        return genome(bnp).get_intervals(iv).get_sorted_stream().compute()
    got, _ = both(run)
    assert [str(c) for c in got.data.chromosome.tolist()] == \
        ["chr1", "chr1", "chr2", "chr3"]


@pytest.mark.parametrize("seed", SEEDS)
def test_map_locations(seed):
    def run(bnp):
        cols = seeded_intervals(seed, n=10, width=600)
        named = bnp.datatypes.NamedInterval(
            *cols, [f"iv{i}" for i in range(len(cols[1]))])
        gi = genome(bnp).get_intervals(named)
        locs = seeded_intervals(seed + 1, n=30)
        entries = bnp.LocationEntry(locs[0], locs[1])
        return gi.map_locations(entries)
    both(run)


def test_coordinate_mapping_find_indices():
    positions = np.array([1, 4, 4, 9, 15, 22])

    def run(bnp, mapping):
        iv = bnp.datatypes.Interval(["a"] * 3, [0, 4, 20], [5, 16, 30])
        entries = bnp.LocationEntry(["a"] * len(positions), positions)
        return (mapping.find_indices(positions, iv),
                mapping.map_locations(entries, iv))
    assert_same(run(tbnp, tmap), run(jbnp, jmap))


def test_from_fields_and_from_track():
    def run(bnp):
        g = genome(bnp)
        ctx = g.get_genome_context()
        gi = bnp.GenomicIntervals.from_fields(ctx, ["chr1", "chr2"], [3, 0],
                                              [40, 9], strand=["+", "-"])
        track = g.get_track(bedgraph(bnp, 5))
        return gi, bnp.GenomicIntervals.from_track(track > 3)
    both(run)


# -- genome context and files -------------------------------------------------

@pytest.mark.parametrize("filt", ["ignore_underscores", "keep_all", None])
def test_genome_context_masking(filt):
    def run(bnp, ctx_mod):
        f = getattr(ctx_mod, filt) if filt else None
        ctx = bnp.genomic_data.GenomeContext.from_dict(SIZES, f)
        data = bnp.datatypes.Interval(["chr1", "chr3_alt", "chr2"],
                                      [0, 0, 5], [10, 10, 15])
        masked = ctx.mask_data(data)
        wider = ctx.with_ignored_added(["chr9"])
        return (masked, ctx.chrom_sizes, ctx.size, repr(ctx),
                wider.chrom_sizes, ctx.is_compatible(wider))
    assert_same(run(tbnp, tctx), run(jbnp, jctx))


def test_genome_context_order_errors():
    for bnp in (tbnp, jbnp):
        ctx = bnp.genomic_data.GenomeContext.from_dict(MAIN)
        bad = bnp.datatypes.Interval(["chr2", "chr1"], [0, 0], [1, 1])
        with pytest.raises(bnp.genomic_data.GenomeError):
            list(ctx.iter_chromosomes(bad, bnp.datatypes.Interval))
        extra = bnp.datatypes.Interval(["chr1", "chr7"], [0, 0], [1, 1])
        with pytest.raises(bnp.genomic_data.GenomeError):
            list(ctx.iter_chromosomes(extra, bnp.datatypes.Interval))


@pytest.mark.parametrize("seed", SEEDS)
def test_genome_from_fasta(seed, tmp_path):
    seqs = genome_seq(seed)
    paths = {}
    for key in PACKAGES:
        (tmp_path / key).mkdir()
        paths[key] = tmp_path / key / "genome.fa"
        write_fasta(paths[key], seqs)

    def run(key):
        bnp = PACKAGES[key]
        g = bnp.Genome.from_file(str(paths[key]))
        seq = g.read_sequence()
        iv = g.get_intervals(intervals(bnp, seed, stranded=True),
                             stranded=True)
        return (g.get_genome_context().chrom_sizes, seq["chr2"],
                seq[iv], seq.extract_intervals(iv.data, stranded=True),
                str(g), g.size)
    got, want = run("torch"), run("jax")
    assert_same(got, want)
    assert (tmp_path / "torch" / "genome.fa.fai").exists()
    assert got[1].to_string() == seqs["chr2"]


@pytest.mark.parametrize("seed", SEEDS)
def test_read_intervals_and_merge(seed, tmp_path):
    sizes_path, bed_path = tmp_path / "g.chrom.sizes", tmp_path / "a.bed"
    write_sizes(sizes_path)
    write_bed(bed_path, seeded_intervals(seed, sizes=SIZES))

    def run(bnp):
        g = bnp.Genome.from_file(str(sizes_path))
        iv = g.read_intervals(str(bed_path))
        return (iv, iv.merged(), g.get_genome_context().chrom_sizes,
                bnp.Genome.from_file(str(sizes_path), sort_names=True,
                                     filter_function=None).size)
    got, _ = both(run)
    assert len(got[1]) <= len(got[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_read_intervals_stream_matches_full(seed, tmp_path):
    bed_path = tmp_path / "a.bed"
    write_bed(bed_path, seeded_intervals(seed, n=200))

    def run(bnp):
        g = genome(bnp)
        full = g.read_intervals(str(bed_path)).get_pileup()
        streamed = g.read_intervals(str(bed_path), stream=True).get_pileup()
        s_max = bnp.compute(np.max(g.read_intervals(str(bed_path),
                                                    stream=True).get_pileup()))
        return (full.to_dict(), np.mean(full), bnp.compute(np.mean(streamed)),
                np.max(full), s_max)
    got, _ = both(run)
    assert got[1] == got[2] and got[3] == got[4]


@pytest.mark.parametrize("stream", [False, True])
def test_read_locations(stream, tmp_path):
    bed_path = tmp_path / "loc.bed"
    write_bed(bed_path, seeded_intervals(6, n=50))

    def run(bnp):
        locs = genome(bnp).read_locations(
            str(bed_path), stream=stream,
            buffer_type=bnp.io.delimited_buffers.BedBuffer)
        return locs.compute() if stream else locs
    both(run)


def test_read_annotation(tmp_path):
    path = tmp_path / "genes.gtf"
    write_gtf(path, 3)

    def run(bnp):
        ann = genome(bnp).read_annotation(str(path))
        return (ann.genes, ann.transcripts, ann.exons,
                ann.genes.gene_id, ann.transcripts.transcript_id,
                ann.exons.exon_id)
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_transcript_sequences(seed, tmp_path):
    path = tmp_path / "genes.gtf"
    write_gtf(path, seed)
    seqs = genome_seq(seed, MAIN)

    def run(bnp):
        from importlib import import_module
        genes = import_module(bnp.__name__ + ".sequence.genes")
        gtf = bnp.open(str(path)).read()
        chrom = gtf[np.asarray([str(c) == "chr1"
                                for c in gtf.chromosome.tolist()])]
        return genes.get_transcript_sequences(chrom, seqs["chr1"])
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_binned_genome(seed, tmp_path):
    bed_path, sizes_path = tmp_path / "loc.bed", tmp_path / "g.chrom.sizes"
    cols = seeded_intervals(seed, n=80)
    write_bed(bed_path, cols)
    write_sizes(sizes_path)

    def run(bnp):
        binned = bnp.genomic_data.BinnedGenome(
            genome(bnp).get_genome_context(), bin_size=250)
        binned.count(bnp.LocationEntry(cols[0], cols[1]))
        binned.count_file(str(bed_path), position_field="start")
        from_file = bnp.genomic_data.BinnedGenome.from_file(str(sizes_path),
                                                            bin_size=500)
        return binned.count_dict, binned["chr3"], from_file.count_dict
    both(run)


# -- sequences ----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_genomic_sequence_from_dict(seed):
    seqs = genome_seq(seed, MAIN)

    def run(bnp):
        gs = bnp.genomic_data.GenomicSequence.from_dict(seqs)
        g = genome(bnp)
        iv = g.get_intervals(intervals(bnp, seed, stranded=True),
                             stranded=True)
        cols = seeded_intervals(seed + 1, n=25)
        chrom = bnp.as_encoded_array(cols[0])
        inner = np.clip(cols[1], 2, None)
        inside = inner + 2 < np.array([MAIN[c] for c in cols[0]])
        mask = g.get_track(bedgraph(bnp, seed)) > 4
        return (gs["chr1"], gs[iv], gs.extract_intervals(iv, stranded=True),
                gs.window_matrix(chrom[inside], inner[inside], 2),
                gs.window_matrix(chrom, np.zeros(len(chrom), int), 2),
                gs[mask], gs.genome_context.chrom_sizes)
    got, _ = both(run)
    assert got[4] is None


# -- geometry -----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_geometry(seed):
    def run(bnp):
        geom = bnp.genomic_data.Geometry(MAIN)
        a, b = intervals(bnp, seed), intervals(bnp, seed + 7)
        a_s = intervals(bnp, seed, stranded=True)
        c = intervals(bnp, seed + 9, n=10)
        sizes = bnp.datatypes.ChromosomeSize(list(MAIN), list(MAIN.values()))
        return (geom.jaccard(a, b), geom.jaccard_all_vs_all([a, b, c]),
                geom.get_mask(a).to_dict(), geom.get_pileup(b).to_dict(),
                geom.clip(geom.extend_to_size(a_s, 400)),
                geom.merge_intervals(intervals(bnp, seed,
                                               sizes={"chr1": 3000})),
                geom.sort(b[::-1]),
                geom.get_track(bedgraph(bnp, seed)).to_dict(),
                bnp.genomic_data.Geometry.from_chrom_sizes(sizes).size(),
                geom.names(), geom.chrom_size("chr2"))
    both(run)


@pytest.mark.parametrize("seed", SEEDS)
def test_streamed_geometry(seed):
    def run(bnp):
        geom = bnp.genomic_data.StreamedGeometry(MAIN)
        def stream(data):
            return bnp.streams.NpDataclassStream(iter([data]),
                                                 dataclass=type(data))

        def iv():
            return stream(intervals(bnp, seed))
        return (geom.get_pileup(iv()).compute().to_dict(),
                bnp.compute(geom.extend_to_size(
                    stream(intervals(bnp, seed, stranded=True)), 400)),
                bnp.compute(geom.clip(iv())),
                bnp.compute(geom.merge_intervals(iv())),
                geom.get_track(stream(bedgraph(bnp, seed))).compute()
                .to_dict())
    both(run)


def test_genomic_streamed_mean_pipeline():
    def run(bnp):
        g = genome(bnp, {"chr1": 100, "chr2": 50})
        chunks = [bnp.datatypes.BedGraph(["chr1"], [0], [100], [2.0]),
                  bnp.datatypes.BedGraph(["chr2"], [0], [50], [4.0])]
        stream = bnp.streams.NpDataclassStream(
            iter(chunks), dataclass=bnp.datatypes.BedGraph)
        track = bnp.GenomicArray.from_bedgraph(stream,
                                               g.get_genome_context())
        return bnp.compute(np.sum(track * 2))
    got, _ = both(run)
    assert got == 2 * (100 * 2.0 + 50 * 4.0)
