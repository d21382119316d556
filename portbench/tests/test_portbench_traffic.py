"""The generator: the same seed gives the same bytes, and the genome
length, read length, qualities, error rate and false member candidate
are those of the file."""
import gzip
import zlib

import numpy as np

import tiny
from portbench import traffic


def _fastq(tmp_path, seed, name):
    reg = tiny.registry(tmp_path)
    cell = reg.cell("minimizer21-fastq-gz")
    cfg = reg.config(cell["config"])
    [inp] = traffic.make_inputs(cell, cfg, seed, str(tmp_path / name))
    return cfg, inp


def test_same_seed_same_bytes(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "c").mkdir()
    _, a = _fastq(tmp_path, 2 ** 31 + 12345, "a")
    _, b = _fastq(tmp_path, 2 ** 31 + 12345, "b")
    _, c = _fastq(tmp_path, 2 ** 31 + 12346, "c")
    bytes_a = open(a.path, "rb").read()
    assert bytes_a == open(b.path, "rb").read()
    assert bytes_a != open(c.path, "rb").read()
    assert np.array_equal(a.flat, b.flat)
    assert a.n_bases == c.n_bases and a.n_reads == c.n_reads


def test_fastq_holds_the_codes(tmp_path):
    (tmp_path / "a").mkdir()
    cfg, inp = _fastq(tmp_path, 7, "a")
    lines = gzip.open(inp.path).read().split(b"\n")[:-1]
    reads = cfg["reads"]
    assert len(lines) == 4 * reads["n_reads"]
    seqs = np.frombuffer(b"".join(lines[1::4]), np.uint8)
    assert np.array_equal(seqs, traffic.LETTERS[inp.flat])
    assert {len(x) for x in lines[1::4]} == {reads["read_length"]}
    assert lines[0].startswith(b"@A00000:1:HSIMXXXXX:1:1101:000000000 ")
    assert len({len(x) for x in lines[0::4]}) == 1
    quals = np.frombuffer(b"".join(lines[3::4]), np.uint8)
    weights = reads["quality_weights"]
    for char, w in weights.items():
        share = np.mean(quals == ord(char))
        assert abs(share - w / sum(weights.values())) < 0.01
    assert set(np.unique(quals).tobytes().decode()) == set(weights)
    # members of whole records, and false member candidates only where
    # the configuration plants them, inside the deflate data
    gz = cfg["fastq_gz"]
    n_members = reads["n_reads"] // gz["reads_per_member"]
    data = open(inp.path, "rb").read()
    starts = [0]
    while len(starts) <= n_members:
        d = zlib.decompressobj(31)
        d.decompress(data[starts[-1]:])
        starts.append(len(data) - len(d.unused_data))
    assert starts[-1] == len(data) and len(starts) == n_members + 1
    planted = [traffic.false_candidates(data[a:b])
               for a, b in zip(starts, starts[1:])]
    assert sum(planted) == len(gz["false_member_candidates"]) == 1
    m = planted.index(1)
    assert m == int(gz["false_member_candidates"][0] * n_members)
    member = data[starts[m]:starts[m + 1]]
    assert member[3] == 0  # no header field holds it
    assert 10 < member.find(traffic.GZ_MAGIC, 1) < len(member) - 8


def test_member_without_and_with_a_false_candidate():
    sizes = [60_000]
    codes = traffic.ReadSampler(traffic.genome(sizes, 4), sizes, 150,
                                0.001).draw(400, traffic.rng_for(4, 1))
    quals = traffic.quality_table({"F": 17, "8": 3})[
        traffic.rng_for(4, 2).integers(0, 20, codes.shape)]
    rec = traffic.fastq_records(codes, 0, "@r{} x", quals)
    raw, width = rec.tobytes(), rec.shape[1]
    at = 200 * width + width - 151
    assert raw[at - 2: at] == b"+\n"
    for plant in (None, at):
        member = traffic.gzip_member(raw, 1, plant, width)
        assert zlib.decompress(member, 31) == raw
        assert traffic.false_candidates(member) == int(plant is not None)
    assert traffic.false_candidates(b"x\x1f\x8b\x08\x00y") == 1
    assert traffic.false_candidates(b"x\x1f\x8b\x08\xe0y") == 0


def test_phred_error_rate():
    assert abs(traffic.phred_error_rate({"I": 1}) - 1e-4) < 1e-12
    assert abs(traffic.phred_error_rate({"+": 1, "I": 3})
               - (0.1 + 3e-4) / 4) < 1e-12
    assert abs(traffic.phred_error_rate({"F": 17, "8": 3})
               - (0.85 * 10 ** -3.7 + 0.15 * 10 ** -2.3)) < 1e-12


def test_reads_come_from_the_genome_with_the_error_rate():
    sizes = [30_000, 10_000]
    codes = traffic.genome(sizes, 3)
    assert codes.size == sum(sizes) and codes.max() == 3
    rate = 0.02
    noisy = traffic.ReadSampler(codes, sizes, 150, rate).draw(
        4000, traffic.rng_for(3, 9))
    clean = traffic.ReadSampler(codes, sizes, 150, 0.0).draw(
        4000, traffic.rng_for(3, 9))
    assert noisy.shape == (4000, 150)
    assert abs(np.mean(noisy != clean) - rate) < 0.002
    text = traffic.LETTERS[codes].tobytes()
    rc = traffic.LETTERS[3 - codes[::-1]].tobytes()
    strands = set()
    for row in clean[:200]:
        read = traffic.LETTERS[row].tobytes()
        fwd, rev = text.find(read), rc.find(read)
        assert fwd >= 0 or rev >= 0
        if fwd >= 0:
            # inside one chromosome
            assert fwd + 150 <= sizes[0] or fwd >= sizes[0]
        strands.add(fwd >= 0)
    assert strands == {True, False}


def test_strains_and_arrays(tmp_path):
    reg = tiny.registry(tmp_path)
    cfg = reg.config("minimizer21-sacCer3-strains")
    [inp] = traffic.make_inputs(reg.cell("minimizer21-genome"), cfg, 5,
                                str(tmp_path))
    sizes = list(cfg["genome"]["chromosome_sizes"].values())
    n = cfg["strains"]["n_strains"]
    assert list(inp.lengths) == sizes * n
    per = sum(sizes)
    base = inp.flat[:per]
    for v in range(1, n):
        share = np.mean(inp.flat[v * per:(v + 1) * per] != base)
        assert 0 < share < 2 * cfg["strains"]["substitution_rate"]
    k = reg.config("kmer31-illumina-ecoli")
    arrays = traffic.make_inputs(reg.cell("kmer31-resident"), k, 5,
                                 str(tmp_path))
    assert len(arrays) == k["reads"]["n_arrays"]
    assert {a.n_reads for a in arrays} == {k["reads"]["reads_per_array"]}
    assert not np.array_equal(arrays[0].flat, arrays[1].flat)
