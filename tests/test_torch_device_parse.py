"""The port's device-parse transport against the JAX package's, on the
CPU: ops/parse.py on seeded padded raw batches (well-formed and
malformed), and count_kmers_fastq in every device_parse mode on the
layouts and edge files of test_torch_pipeline.py.  Integer results,
exact equality; on malformed input both packages raise the same error."""
import gzip

import numpy as np
import pytest
import torch

from bionumpy_tpu import pipeline as jpipe
from bionumpy_tpu.encodings import DNAEncoding as JDNA
from bionumpy_tpu.ops import parse as jparse
from bionumpy_tpu_torch import convert, instrument
from bionumpy_tpu_torch import pipeline as tpipe
from bionumpy_tpu_torch.encodings import DNAEncoding
from bionumpy_tpu_torch.ops import parse as tparse
# the seeded FASTQ layouts of the packed transport's tests
from test_torch_pipeline import _fastq, _gz, _members, _unaligned

# one raw bucket throughout, so the JAX side compiles each program once
BUCKET = 1 << 15
MAX_LINES = BUCKET // 16   # what the pipeline passes
CAP = 1 << 12


def _batch(case):
    """(raw bytes, max_lines) of one seeded batch: well-formed, or broken
    in one way."""
    raw = _fastq(60, 3, max_len=120)
    if case == "ok":
        return raw, MAX_LINES
    if case == "no_plus":
        return raw.replace(b"\n+\n", b"\n-\n", 1), MAX_LINES
    if case == "truncated":
        return raw + b"@cut\nACGTACGT\n", MAX_LINES
    if case == "non_acgt":
        head, rest = raw.split(b"\n", 1)
        return head + b"\n" + rest[:10] + b"N" + rest[11:], MAX_LINES
    if case == "short_lines":  # 2-byte lines past max_lines
        return raw + b"@\nA\n+\nI\n" * (MAX_LINES // 4), MAX_LINES
    raise ValueError(case)


CASES = ["ok", "no_plus", "truncated", "non_acgt", "short_lines"]


def _padded(raw):
    assert len(raw) <= BUCKET
    padded = np.zeros(BUCKET, np.uint8)
    padded[: len(raw)] = np.frombuffer(raw, np.uint8)
    return padded


def _lut():
    return torch.from_numpy(DNAEncoding.lookup_table)


@pytest.mark.parametrize("case", CASES)
def test_fastq_scan_matches_jax(case):
    raw, max_lines = _batch(case)
    padded = _padded(raw)
    got = tparse.fastq_scan(torch.from_numpy(padded), len(raw), max_lines)
    want = jparse.fastq_scan(padded, np.int32(len(raw)), max_lines)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", CASES)
def test_dense_counts_match_jax(case):
    raw, max_lines = _batch(case)
    padded = _padded(raw)
    k = 5
    got = tparse.fastq_to_kmer_counts(torch.from_numpy(padded), _lut(),
                                      len(raw), max_lines, k, 4 ** k)
    want = jparse.fastq_to_kmer_counts(
        padded, np.asarray(JDNA.lookup_table), np.int32(len(raw)),
        max_lines, k, 4 ** k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("cap", [CAP, 64])  # 64: fewer rows than k-mers
def test_sparse_table_matches_jax(case, cap):
    raw, max_lines = _batch(case)
    padded = _padded(raw)
    k = 31
    (keys, counts), meta = tparse.fastq_to_sparse_kmer_table(
        torch.from_numpy(padded), _lut(), len(raw), max_lines, k, cap)
    table, jmeta = jparse.fastq_to_sparse_kmer_table(
        padded, np.asarray(JDNA.lookup_table), np.int32(len(raw)),
        max_lines, k, cap)
    want_keys, want_counts = convert.table_from_jax(table)
    assert torch.equal(keys, want_keys)
    assert meta.tolist() == np.asarray(jmeta).tolist()
    if int(meta[0]) > cap:
        # an overflowed table (the pipeline reruns the job): its last row
        # holds the same negative difference in both, as uint32 in JAX's
        assert int(counts[-1]) < 0
        counts = counts & 0xFFFFFFFF
    assert torch.equal(counts, want_counts)
    assert bool(meta[3]) == (case == "ok")


@pytest.mark.parametrize("case", ["ok", "no_plus"])
def test_parse_chunk_on_device_matches_jax(case):
    raw, _ = _batch(case)
    arr = np.frombuffer(raw, np.uint8)
    if case == "ok":
        got = tparse.parse_fastq_chunk_on_device(arr, k=5, device="cpu")
        want = jparse.parse_fastq_chunk_on_device(arr, k=5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[2] == 60
        return
    with pytest.raises(ValueError, match="malformed"):
        jparse.parse_fastq_chunk_on_device(arr, k=5)
    with pytest.raises(ValueError, match="malformed"):
        tparse.parse_fastq_chunk_on_device(arr, k=5, device="cpu")


MODES = [True, "device", "auto"]


def _both(path, mode, **kw):
    kw.setdefault("cap", CAP << 2)
    kw.setdefault("acc_cap", 1 << 16)
    got = tpipe.count_kmers_fastq(str(path), device="cpu",
                                  device_parse=mode, **kw)
    expect = jpipe.count_kmers_fastq(str(path), device_parse=mode, **kw)
    return got, expect


def _assert_same(got, expect):
    (g, gs), (e, es) = got, expect
    np.testing.assert_array_equal(g.label_codes, e.label_codes)
    np.testing.assert_array_equal(g.counts, e.counts)
    assert g.counts.dtype == np.int64
    assert gs == es


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout,k,target", [
    ("members", 31, 6000),
    ("members", 15, 40000),
    ("plain", 31, 20000),
    ("unaligned", 31, 9000),
    ("unaligned", 21, 1 << 25),
])
def test_pipeline_matches_jax(tmp_path, mode, layout, k, target):
    members = _members(12)
    if layout == "plain":
        path = tmp_path / "reads.fq"
        path.write_bytes(b"".join(members))
    else:
        path = tmp_path / "reads.fq.gz"
        parts = members if layout == "members" else \
            _unaligned(b"".join(members))
        path.write_bytes(_gz(parts))
    instrument.reset()
    got, expect = _both(path, mode, k=k, target_bases=target)
    _assert_same(got, expect)
    assert got[1]["n_reads"] == 12 * 200 and got[1]["n_kmers"] > 0
    # which transport ran: a raw batch is padded ("pad"), a packed one
    # parsed on the host (or arrives parsed from entry-aligned members)
    stages = instrument.report()
    raw_batches = stages.get("pad", {}).get("calls", 0)
    n_batches = stages["dispatch"]["calls"]
    per_run = n_batches // stages["D2H-table"]["calls"]  # a cap rerun
    if mode != "auto":
        assert raw_batches == n_batches
    elif layout == "members" or per_run < 2:
        assert raw_batches == 0
    else:  # batch 1 probes the device transport
        assert raw_batches >= 1
    packed = tpipe.count_kmers_fastq(str(path), k, cap=CAP << 2,
                                     acc_cap=1 << 16, target_bases=target,
                                     device="cpu", device_parse=False)
    _assert_same(got, packed)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("content,k,expect_reads", [
    (b"", 31, 0),                                      # empty member
    (b"@r1\nACGTACGT\n+\nIIIIIIII", 5, 1),             # no trailing \n
    (b"@r1\nACGTACGTACGT\n+\nIIIIIIIIIIII\n", 5, 1),
])
def test_pipeline_edge_files(tmp_path, mode, content, k, expect_reads):
    path = tmp_path / "edge.fq.gz"
    path.write_bytes(gzip.compress(content))
    got, expect = _both(path, mode, k=k, cap=1 << 10)
    _assert_same(got, expect)
    assert got[1]["n_reads"] == expect_reads


@pytest.mark.parametrize("mode", [True, "device"])
def test_pipeline_non_acgt_raises_like_jax(tmp_path, mode):
    raw = _fastq(50, 4).replace(b"\nA", b"\nN", 1)
    path = tmp_path / "bad.fq.gz"
    path.write_bytes(_gz([raw]))
    with pytest.raises(ValueError, match="device scan"):
        jpipe.count_kmers_fastq(str(path), 31, device_parse=mode)
    with pytest.raises(ValueError, match="device scan"):
        tpipe.count_kmers_fastq(str(path), 31, device="cpu",
                                device_parse=mode)
