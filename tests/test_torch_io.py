"""Parity of the port's file layer (io/: the readers, buffers and writers,
bnp.open / read / count_entries / read_chunks, io/matrix_dump) with the
JAX package's, on the CPU.  These are host modules, copied; each case
runs the same calls through both packages on the same seeded files and
compares what comes out as plain Python and numpy values (never the two
packages' objects with each other).  Cases follow
tests/test_roundtrip_matrix.py, tests/test_io.py and
tests/test_error_paths.py; the last ones drive the chunked k-mer and
motif calls of the port over a gzip FASTQ on the CPU."""
import dataclasses
import gzip
import importlib
import struct

import numpy as np
import pytest
from test_roundtrip_matrix import MATRIX

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp

PACKAGES = ("bionumpy_tpu", "bionumpy_tpu_torch")


def _io(root):
    return importlib.import_module(root + ".io")


def plain(x):
    """Any record batch or column of either package as plain values: a
    dict of fields, (tag, numpy arrays) for the array types, lists for
    string arrays.  Lazy batches are made eager first."""
    if hasattr(x, "get_data_object"):
        x = x.get_data_object()
    name = type(x).__name__
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if name == "EncodedRaggedArray":
        return ("ERA", type(x.encoding).__name__, np.asarray(x.lengths),
                np.asarray(x.ravel().raw()))
    if name == "EncodedArray":
        if type(x.encoding).__name__ == "StringEncoding":
            return ("categorical", [str(s) for s in
                                    x.encoding.decode(x).tolist()])
        return ("EA", type(x.encoding).__name__, np.asarray(x.raw()))
    if name == "RaggedArray":
        return ("RA", np.asarray(x.lengths), np.asarray(x.ravel()))
    if name == "StringArray":
        return ("SA", [str(s) for s in x.tolist()])
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def equal(a, b):
    """Nested equality of plain values; numpy arrays by dtype, shape and
    value (NaN equal to NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            equal(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            equal(a[key], b[key])
    else:
        assert type(a) is type(b) and a == b, (a, b)


def same(fn):
    """fn(package root) through the JAX package and the port: equal plain
    results.  Returns the port's."""
    want, got = (fn(root) for root in PACKAGES)
    equal(got, want)
    return got


# ---- the format matrix ----------------------------------------------------

def _buffer(root, fmt):
    buffer_type = MATRIX[fmt][0]
    io = _io(root)
    if buffer_type.__name__ == "_Mfa6":
        return type("_Mfa6", (io.MultiLineFastaBuffer,),
                    {"n_characters_per_line": 6})
    return getattr(io, buffer_type.__name__)


def _parse(buffer_type, text):
    tail = ">" if buffer_type.__name__ == "_Mfa6" else ""
    raw = np.frombuffer((text + tail).encode(), dtype=np.uint8)
    return buffer_type.from_raw_buffer(raw).get_data()


@pytest.mark.parametrize("fmt", sorted(MATRIX))
def test_format_matrix_parses_and_writes_alike(fmt):
    text = MATRIX[fmt][1]

    def run(root):
        buffer_type = _buffer(root, fmt)
        data = _parse(buffer_type, text)
        written = bytes(buffer_type.from_data(data).raw())
        return plain(data), written

    _, written = same(run)
    assert written.decode() == text


@pytest.mark.parametrize("fmt", sorted(MATRIX))
def test_format_matrix_write_parse_alike(fmt):
    text = MATRIX[fmt][1]

    def run(root):
        buffer_type = _buffer(root, fmt)
        data = _parse(buffer_type, text)
        if hasattr(data, "get_data_object"):
            data = data.get_data_object()
        rewritten = bytes(buffer_type.from_data(data).raw())
        return plain(_parse(buffer_type, rewritten.decode())), rewritten

    same(run)


# ---- seeded files through bnp.open ----------------------------------------

def _fastq_text(seed, n):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i in range(n):
        seq = letters[rng.integers(0, 4, int(rng.integers(1, 160)))]
        qual = rng.integers(33, 74, len(seq)).astype(np.uint8)
        out.append(b"@r%d extra\n%s\n+\n%s\n" % (i, seq.tobytes(),
                                                 qual.tobytes()))
    return b"".join(out)


def _fasta_text(seed, n):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    out = []
    for i in range(n):
        seq = letters[rng.integers(0, 5, int(rng.integers(1, 300)))]
        lines = [seq[j: j + 60].tobytes() for j in range(0, len(seq), 60)]
        out.append(b">c%d\n%s\n" % (i, b"\n".join(lines)))
    return b"".join(out)


def _bed_text(seed, n):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 10 ** 6, n)
    return b"".join(b"chr%d\t%d\t%d\n" % (c, s, s + w) for c, s, w in zip(
        rng.integers(1, 5, n), starts, rng.integers(1, 900, n)))


def _vcf_text(seed, n):
    rng = np.random.default_rng(seed)
    header = (b"##fileformat=VCFv4.2\n"
              b"##INFO=<ID=AC,Number=1,Type=Integer,Description=\"c\">\n"
              b"##INFO=<ID=DB,Number=0,Type=Flag,Description=\"f\">\n"
              b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    letters = "ACGT"
    body = []
    for i, pos in enumerate(np.sort(rng.integers(1, 10 ** 6, n))):
        ref = "".join(rng.choice(list(letters), int(rng.integers(1, 4))))
        alt = "".join(rng.choice(list(letters), int(rng.integers(1, 4))))
        info = f"AC={int(rng.integers(1, 99))}" + (
            ";DB" if rng.random() < 0.3 else "")
        body.append(f"chr{1 + i % 2}\t{pos}\trs{i}\t{ref}\t{alt}\t50\t"
                    f"PASS\t{info}\n")
    return header + "".join(body).encode()


def _gtf_text(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        start = int(rng.integers(1, 10 ** 5))
        kind = ("gene", "transcript", "exon")[i % 3]
        out.append(f"chr1\tsrc\t{kind}\t{start}\t{start + 99}\t.\t"
                   f"{'+-'[i % 2]}\t.\tgene_id \"g{i // 3}\"; "
                   f"transcript_id \"t{i // 3}\";\n")
    return "".join(out).encode()


def _sam_text(seed, n):
    rng = np.random.default_rng(seed)
    out = [b"@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:100000\n"]
    for i in range(n):
        seq = "".join(rng.choice(list("ACGT"), 25))
        out.append(f"q{i}\t{int(rng.choice([0, 16]))}\tchr1\t"
                   f"{int(rng.integers(1, 99000))}\t{int(rng.integers(0, 61))}"
                   f"\t25M\t*\t0\t0\t{seq}\t{'I' * 25}\tAS:i:0\n".encode())
    return b"".join(out)


def _write(path, text, members=1):
    if path.suffix == ".gz":
        step = -(-len(text) // members)
        cuts = [0]
        for m in range(1, members):  # members end on whole lines
            cuts.append(text.index(b"\n", m * step) + 1)
        cuts.append(len(text))
        path.write_bytes(b"".join(gzip.compress(text[a:b], mtime=0)
                                  for a, b in zip(cuts, cuts[1:])))
    else:
        path.write_bytes(text)
    return str(path)


FILES = {
    "fq": ("reads.fq", _fastq_text, 400, 1),
    "fq_gz": ("reads.fq.gz", _fastq_text, 400, 1),
    "fq_gz_members": ("members.fq.gz", _fastq_text, 400, 5),
    "fa": ("contigs.fa", _fasta_text, 120, 1),
    "bed": ("intervals.bed", _bed_text, 900, 1),
    "vcf_gz": ("sites.vcf.gz", _vcf_text, 600, 3),
    "gtf": ("genes.gtf", _gtf_text, 300, 1),
    "sam": ("reads.sam", _sam_text, 300, 1),
}


@pytest.fixture(params=sorted(FILES))
def seeded_file(request, tmp_path):
    name, make, n, members = FILES[request.param]
    return _write(tmp_path / name, make(11, n), members), n


def test_read_and_count_entries_alike(seeded_file):
    path, n = seeded_file
    got = same(lambda root: (importlib.import_module(root).count_entries(
        path), plain(importlib.import_module(root).read(path))))
    assert got[0] == n


@pytest.mark.parametrize("min_chunk_size", [3000, 8000])
def test_read_chunks_cut_alike(seeded_file, min_chunk_size):
    """Both packages cut a file into the same chunks (the same entry
    count in each) and the chunks hold the whole file."""
    path, n = seeded_file

    def run(root):
        bnp = importlib.import_module(root)
        chunks = list(bnp.open(path).read_chunks(
            min_chunk_size=min_chunk_size))
        return [len(c) for c in chunks], [plain(c) for c in chunks]

    sizes, _ = same(run)
    assert sum(sizes) == n and len(sizes) >= 2


@pytest.mark.parametrize("lazy", [True, False])
def test_lazy_and_eager_reads_alike(seeded_file, lazy):
    path, _ = seeded_file

    def run(root):
        bnp = importlib.import_module(root)
        with bnp.open(path, lazy=lazy) as f:
            data = f.read()
        return type(data).__name__, plain(data)

    same(run)
    eager = plain(tbnp.open(path, lazy=False).read())
    equal(plain(tbnp.open(path, lazy=True).read()), eager)


def test_read_chunks_lazy_choice_alike(tmp_path):
    """npdataclassreader's lazy choice: delimited chunks lazy, GTF
    eager, FASTQ per the buffer; the config switch turns it off."""
    paths = [_write(tmp_path / n, make(3, 50)) for n, make in (
        ("a.bed", _bed_text), ("a.gtf", _gtf_text), ("a.fq", _fastq_text))]

    def run(root):
        bnp = importlib.import_module(root)
        config = importlib.import_module(root + ".config")
        kinds = [[type(c).__module__.endswith("lazybnpdataclass")
                  for c in bnp.open(p).read_chunks(1000)] for p in paths]
        with config.ConfigContext(LAZY=False):
            off = [type(bnp.open(p).read()).__module__.endswith(
                "lazybnpdataclass") for p in paths]
        return kinds, off

    kinds, off = same(run)
    assert kinds[0][0] and not kinds[1][0] and off == [False] * 3


def test_write_round_trip_alike(tmp_path):
    """bnp.open(path, "w") in both packages: identical bytes for a FASTQ
    read from gzip, a BED, and a multi-line FASTA's chunk stream written
    as a two-line FASTA."""
    src = _write(tmp_path / "in.fq.gz", _fastq_text(5, 200), 3)
    bed = _write(tmp_path / "in.bed", _bed_text(5, 300))
    contigs = _write(tmp_path / "in.fa", _fasta_text(5, 200))

    def run(root):
        bnp = importlib.import_module(root)
        out = []
        for source, suffix in ((src, "fq"), (bed, "bed")):
            target = tmp_path / f"{root}.{suffix}"
            with bnp.open(str(target), "w") as f:
                f.write(bnp.open(source).read())
            out.append(target.read_bytes())
        fa = tmp_path / f"{root}.fa"
        with bnp.open(str(fa), "w",
                      buffer_type=bnp.TwoLineFastaBuffer) as f:
            f.write(bnp.open(contigs).read_chunks(4000))
        out.append(fa.read_bytes())
        return out

    fq, bed_bytes, fa = same(run)
    assert fq == gzip.decompress((tmp_path / "in.fq.gz").read_bytes())
    assert bed_bytes == (tmp_path / "in.bed").read_bytes()
    assert fa.count(b">") == 200


# ---- FormatException line numbers (tests/test_io.py, test_error_paths) ----

FASTQ_TEXT = "@read1\nACGT\n+\nIIII\n@read2\nGGTTA\n+\n!!!!!\n"


@pytest.mark.parametrize("bad, line", [
    (FASTQ_TEXT.replace("@read2", "Xread2"), 4),
    (FASTQ_TEXT.replace("+\nIIII", "x\nIIII"), 2)])
def test_fastq_format_errors_alike(bad, line):
    def run(root):
        buffer_type = _io(root).FastQBuffer
        exc = importlib.import_module(root + ".io.exceptions")
        with pytest.raises(exc.FormatException) as err:
            buffer_type.from_raw_buffer(np.frombuffer(bad.encode(),
                                                      np.uint8))
        return err.value.line_number

    assert same(run) == line


def test_error_line_numbers_across_chunks_alike(tmp_path):
    entries = [f"@r{i}\nACGT\n+\nIIII\n" for i in range(100)]
    entries[60] = "Xbad\nACGT\n+\nIIII\n"
    fq = tmp_path / "broken.fq"
    fq.write_text("".join(entries))
    bed = tmp_path / "bad.bed"
    bed.write_text("chr1\t1\t10\nchr1\t2x\t20\nchr1\t3\t30\n")

    def run(root):
        bnp = importlib.import_module(root)
        exc = importlib.import_module(root + ".io.exceptions")
        with pytest.raises(exc.FormatException) as fq_err:
            for chunk in bnp.open(str(fq)).read_chunks(min_chunk_size=500):
                _ = chunk.sequence
        with pytest.raises(exc.FormatException) as bed_err:
            bnp.open(str(bed)).read().start
        return fq_err.value.line_number, bed_err.value.line_number

    assert same(run) == (240, 1)


# ---- BAM: made here, written by the JAX package's writer ------------------

_SEQ_CODES = "=ACMGRSVTWYHKDBN"


def _bam_bytes(seed, n):
    """A BAM stream (header + n records, one gzip member) in the binary
    layout of the SAM specification, from a seed."""
    rng = np.random.default_rng(seed)
    refs = [(b"chr1", 100000), (b"chr2", 50000)]
    text = b"@HD\tVN:1.6\n"
    head = b"BAM\1" + struct.pack("<i", len(text)) + text + \
        struct.pack("<i", len(refs)) + b"".join(
            struct.pack("<i", len(r) + 1) + r + b"\0" + struct.pack("<i", ln)
            for r, ln in refs)
    records = []
    for i in range(n):
        name = b"read%d\0" % i
        seq = "".join(rng.choice(list("ACGTN"), int(rng.integers(1, 60))))
        ops = [(int(rng.integers(1, 20)), int(rng.integers(0, 9)))
               for _ in range(int(rng.integers(1, 4)))]
        cigar = b"".join(struct.pack("<I", ln << 4 | op) for ln, op in ops)
        codes = [_SEQ_CODES.index(c) for c in seq] + [0]
        packed = bytes(codes[j] << 4 | codes[j + 1]
                       for j in range(0, len(seq), 2))
        qual = rng.integers(0, 41, len(seq)).astype(np.uint8).tobytes()
        fixed = struct.pack("<iiBBHHHiiii", int(rng.integers(0, 2)),
                            int(rng.integers(0, 40000)), len(name),
                            int(rng.integers(0, 61)), 0, len(ops),
                            int(rng.choice([0, 16])), len(seq), -1, -1, 0)
        block = fixed + name + cigar + packed + qual
        records.append(struct.pack("<i", len(block)) + block)
    return gzip.compress(head + b"".join(records), mtime=0)


def test_bam_written_by_the_jax_writer_reads_alike(tmp_path):
    made = tmp_path / "made.bam"
    made.write_bytes(_bam_bytes(2, 300))
    written = tmp_path / "written.bam"
    with jbnp.open(str(written), "w") as f:
        f.write(jbnp.open(str(made)).read())

    def run(root):
        bnp = importlib.import_module(root)
        io = _io(root)
        data = bnp.open(str(written)).read()
        chunks = [len(c) for c in
                  bnp.open(str(written)).read_chunks(min_chunk_size=2000)]
        intervals = bnp.open(str(written),
                             buffer_type=io.BamIntervalBuffer).read()
        return plain(data), chunks, plain(intervals)

    data, chunks, _ = same(run)
    assert sum(chunks) == 300 and len(chunks) > 1
    assert data["name"][1] == [f"read{i}" for i in range(300)]
    with tbnp.open(str(tmp_path / "port.bam"), "w") as f:
        f.write(tbnp.open(str(made)).read())
    assert gzip.decompress((tmp_path / "port.bam").read_bytes()) == \
        gzip.decompress(written.read_bytes())


def test_alignment_to_interval_alike(tmp_path):
    made = tmp_path / "made.bam"
    made.write_bytes(_bam_bytes(4, 120))

    def run(root):
        bnp = importlib.import_module(root)
        alignments = importlib.import_module(root + ".alignments")
        return plain(alignments.alignment_to_interval(
            bnp.open(str(made), lazy=False).read()))

    same(run)


# ---- indexed FASTA, matrices ----------------------------------------------

def test_indexed_fasta_alike(tmp_path):
    path = _write(tmp_path / "genome.fa", _fasta_text(8, 20))

    def run(root):
        bnp = importlib.import_module(root)
        datatypes = importlib.import_module(root + ".datatypes")
        ref = bnp.open_indexed(path)
        lengths = ref.get_contig_lengths()
        iv = datatypes.Interval.from_entry_tuples(
            [("c1", 0, 5), ("c3", 2, 40), ("c0", 1, 2)])
        return (lengths, ref["c2"].to_string(),
                plain(ref.get_interval_sequences(iv)),
                plain(ref.get_contig("c4") if hasattr(ref, "get_contig")
                      else ref["c4"]))

    same(run)


MATRIX_TEXT = "\tA\tC\tG\nrow1\t1.5\t2\t-3e2\nrow2\t0\t7.25\t1\n"


def test_read_matrix_alike(tmp_path):
    path = tmp_path / "m.tsv"
    path.write_text(MATRIX_TEXT)

    def run(root):
        io = _io(root)
        m = io.read_matrix(str(path))
        ints = importlib.import_module(root + ".io.matrix_dump").matrix_to_csv(
            np.arange(6).reshape(2, 3), header=["x", "y", "z"])
        return (m.data, plain(m.row_names), [str(c) for c in m.col_names],
                bytes(np.asarray(ints.raw())))

    m, rows, cols, csv = same(run)
    np.testing.assert_array_equal(m, [[1.5, 2, -300], [0, 7.25, 1]])
    assert cols == ["A", "C", "G"] and csv == b"x,y,z\n0,1,2\n3,4,5\n"


def test_proportion_matrix_alike():
    def run(root):
        bnp = importlib.import_module(root)
        seqs = bnp.as_encoded_array(["ACGGT", "TTA", ""], bnp.DNAEncoding)
        counts = bnp.count_encoded(seqs, axis=-1)
        m = counts.proportion_matrix
        return type(m).__name__, m.data, m.row_names, list(m.col_names)

    same(run)


# ---- the chunked-file idiom on the CPU ------------------------------------

def _reads_file(tmp_path, members=4):
    return _write(tmp_path / "reads.fq.gz", _fastq_text(21, 600), members)


@pytest.mark.parametrize("members", [1, 4])
def test_chunked_kmer_counts_equal_one_call_and_jax(tmp_path, members):
    path = _reads_file(tmp_path, members)
    whole = tbnp.as_encoded_array(tbnp.read(path).sequence,
                                  tbnp.DNAEncoding)
    one = tbnp.count_kmers(whole, 31, device="cpu")
    for size in (4000, 30_000):
        chunked = sum(tbnp.count_kmers(
            tbnp.as_encoded_array(chunk.sequence, tbnp.DNAEncoding), 31,
            device="cpu")
            for chunk in tbnp.open(path).read_chunks(min_chunk_size=size))
        np.testing.assert_array_equal(chunked.label_codes, one.label_codes)
        np.testing.assert_array_equal(chunked.counts, one.counts)
    dense = tbnp.count_kmers(
        (tbnp.as_encoded_array(c.sequence, tbnp.DNAEncoding)
         for c in tbnp.open(path).read_chunks(min_chunk_size=4000)), 5,
        device="cpu")
    jax = jbnp.count_kmers(jbnp.as_encoded_array(jbnp.read(path).sequence,
                                                 jbnp.DNAEncoding), 5)
    np.testing.assert_array_equal(dense.counts, np.asarray(jax.counts))
    assert list(dense.alphabet) == list(jax.alphabet)
    jax31 = jbnp.count_kmers(jbnp.as_encoded_array(
        jbnp.read(path).sequence, jbnp.DNAEncoding), 31)
    np.testing.assert_array_equal(one.label_codes,
                                  np.asarray(jax31.label_codes))
    np.testing.assert_array_equal(one.counts, np.asarray(jax31.counts))


def test_chunked_motif_matches_equal_one_call_and_jax(tmp_path):
    from bionumpy_tpu.sequence.position_weight_matrix import \
        get_motif_matches as jmatches
    path = _reads_file(tmp_path)
    rng = np.random.default_rng(3)
    counts = {c: rng.integers(0, 31, 7).tolist() for c in "ACGT"}
    pwm, jpwm = tbnp.PWM.from_dict(counts), jbnp.PWM.from_dict(counts)
    threshold = 3.0
    rows, offs, row0 = [], [], 0
    for chunk in tbnp.open(path).read_chunks(min_chunk_size=5000):
        s = tbnp.as_encoded_array(chunk.sequence, tbnp.DNAEncoding)
        m = tbnp.get_motif_matches(s, pwm, threshold, device="cpu")
        rows.append(row0 + np.repeat(np.arange(len(m)), m.lengths))
        offs.append(np.asarray(m.ravel()))
        row0 += len(s)
    assert len(rows) > 1
    whole = tbnp.get_motif_matches(tbnp.as_encoded_array(
        tbnp.read(path).sequence, tbnp.DNAEncoding), pwm, threshold,
        device="cpu")
    jax = jmatches(jbnp.as_encoded_array(jbnp.read(path).sequence,
                                         jbnp.DNAEncoding), jpwm, threshold)
    for m in (whole, jax):
        np.testing.assert_array_equal(np.concatenate(rows), np.repeat(
            np.arange(len(m)), np.asarray(m.lengths)))
        np.testing.assert_array_equal(np.concatenate(offs),
                                      np.asarray(m.ravel()))


def test_chunk_sequences_with_other_letters_raise_alike(tmp_path):
    path = _write(tmp_path / "n.fq", b"@a\nACGTN\n+\nIIIII\n")

    def run(root):
        bnp = importlib.import_module(root)
        with pytest.raises(Exception) as err:
            for chunk in bnp.open(path).read_chunks():
                bnp.as_encoded_array(chunk.sequence, bnp.DNAEncoding)
        return type(err.value).__name__

    same(run)


def test_top_level_exports():
    for name in ("open", "bnp_open", "read", "count_entries", "open_indexed",
                 "Matrix", "get_bufferclass_for_datatype",
                 "TwoLineFastaBuffer", "FastQBuffer", "MultiLineFastaBuffer",
                 "BedBuffer", "Bed6Buffer", "NarrowPeakBuffer",
                 "GfaSequenceBuffer", "GFFBuffer", "SAMBuffer"):
        assert getattr(tbnp, name).__module__.startswith(
            "bionumpy_tpu_torch"), name
    assert tbnp.open is tbnp.bnp_open
    assert set(_io("bionumpy_tpu_torch").__all__) == set(
        _io("bionumpy_tpu").__all__)
