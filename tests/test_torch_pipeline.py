"""The port's count_kmers_fastq against the JAX package's, on seeded
synthetic FASTQ files: the hashes, the counts and the stats dict must be
equal (integer results, exact equality).  The port runs on the CPU, its
kernels through their plain versions."""
import gzip

import numpy as np
import pytest

from bionumpy_tpu import pipeline as jpipe
from bionumpy_tpu_torch import pipeline as tpipe

# one batch bucket and one accumulator size throughout, so the JAX side
# compiles each of its programs once per worker
CAP = 1 << 14
ACC_CAP = 1 << 16


def _fastq(n_reads, seed, max_len=150):
    """Seeded FASTQ bytes; reads of 0..max_len bases, a shared prefix so
    k-mers repeat across reads."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len, n_reads)
    codes = rng.integers(0, 4, int(lengths.sum()))
    alpha = np.frombuffer(b"ACGT", np.uint8)
    seq = alpha[codes].tobytes().decode()
    out, pos = [], 0
    for i, n in enumerate(lengths):
        s = ("ACGTTGCA" * 20)[: n // 3] + seq[pos: pos + n - n // 3]
        pos += n - n // 3
        out.append(f"@r{seed}.{i}\n{s}\n+\n{'I' * n}\n")
    return "".join(out).encode()


def _members(n_members, n_reads=200):
    return [_fastq(n_reads, s) for s in range(n_members)]


def _gz(parts):
    return b"".join(gzip.compress(p, mtime=0) for p in parts)


def _both(path, **kw):
    kw.setdefault("cap", CAP)
    kw.setdefault("acc_cap", ACC_CAP)
    got = tpipe.count_kmers_fastq(str(path), device="cpu", **kw)
    expect = jpipe.count_kmers_fastq(str(path), device_parse=False, **kw)
    return got, expect


def _assert_same(got, expect):
    (g, gs), (e, es) = got, expect
    np.testing.assert_array_equal(g.label_codes, e.label_codes)
    np.testing.assert_array_equal(g.counts, e.counts)
    assert g.counts.dtype == np.int64
    assert gs == es


def _unaligned(raw, n_pieces=7):
    cuts = np.linspace(0, len(raw), n_pieces + 1).astype(int) + 13
    cuts[0], cuts[-1] = 0, len(raw)
    return [raw[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


@pytest.mark.parametrize("layout,k,target", [
    ("members", 31, 6000),     # 12 batches: more than ACC_FOLD
    ("members", 15, 40000),    # several members per batch
    ("plain", 31, 20000),
    ("unaligned", 31, 9000),   # members cut mid-entry: the slab path
    ("unaligned", 21, 1 << 25),
])
def test_matches_jax(tmp_path, layout, k, target):
    members = _members(12)
    if layout == "plain":
        path = tmp_path / "reads.fq"
        path.write_bytes(b"".join(members))
    else:
        path = tmp_path / "reads.fq.gz"
        parts = members if layout == "members" else \
            _unaligned(b"".join(members))
        path.write_bytes(_gz(parts))
    got, expect = _both(path, k=k, target_bases=target)
    _assert_same(got, expect)
    assert got[1]["n_reads"] == 12 * 200 and got[1]["n_kmers"] > 0


def test_cap_overflow_reruns_like_jax(tmp_path, caplog):
    path = tmp_path / "reads.fq.gz"
    path.write_bytes(_gz(_members(3)))
    got, expect = _both(path, k=31, cap=1 << 10, target_bases=20000)
    _assert_same(got, expect)
    assert "rerunning at cap" in caplog.text


def test_acc_overflow_like_jax(tmp_path):
    path = tmp_path / "reads.fq.gz"
    path.write_bytes(_gz(_members(3, n_reads=100)))
    kw = dict(k=31, cap=CAP, acc_cap=5000, target_bases=6000)
    with pytest.raises(jpipe.AccOverflow):
        jpipe.count_kmers_fastq(str(path), device_parse=False, **kw)
    with pytest.raises(tpipe.AccOverflow) as err:
        tpipe.count_kmers_fastq(str(path), device="cpu", **kw)
    assert int(err.value.meta_h[0]) <= CAP  # no batch overflowed its cap


@pytest.mark.parametrize("spill_limit,spill_windows", [
    (20000, None),     # host spill every batch or two
    ((1 << 31) - 1, 1),  # overlap spill after every fold
])
def test_spill_matches_jax(tmp_path, monkeypatch, spill_limit,
                           spill_windows):
    monkeypatch.setattr(jpipe, "_SPILL_LIMIT", spill_limit)
    monkeypatch.setattr(tpipe, "_SPILL_LIMIT", spill_limit)
    path = tmp_path / "reads.fq.gz"
    path.write_bytes(_gz(_members(10)))
    got, expect = _both(path, k=31, target_bases=6000,
                        spill_windows=spill_windows)
    _assert_same(got, expect)


def test_truncated_fastq_raises(tmp_path):
    raw = b"".join(_members(2)) + b"@cut\nACGTACGT"
    path = tmp_path / "cut.fq.gz"
    path.write_bytes(_gz([raw]))
    with pytest.raises(ValueError, match="truncated"):
        jpipe.count_kmers_fastq(str(path), 31, device_parse=False)
    with pytest.raises(ValueError, match="truncated"):
        tpipe.count_kmers_fastq(str(path), 31, device="cpu")


@pytest.mark.parametrize("content,k,expect_reads", [
    (b"", 31, 0),                                      # empty member
    (b"@r1\nACGTACGT\n+\nIIIIIIII", 5, 1),             # no trailing \n
    (b"@r1\nACGTACGTACGT\n+\nIIIIIIIIIIII\n", 5, 1),
])
def test_ingest_edge_files(tmp_path, content, k, expect_reads):
    path = tmp_path / "edge.fq.gz"
    path.write_bytes(gzip.compress(content))
    got, expect = _both(path, k=k, cap=1 << 10)
    _assert_same(got, expect)
    assert got[1]["n_reads"] == expect_reads


def test_zero_byte_file(tmp_path):
    path = tmp_path / "zero.fq.gz"
    path.write_bytes(b"")
    got, expect = _both(path, k=31, cap=1 << 10)
    _assert_same(got, expect)
    assert got[1] == {"n_reads": 0, "n_bases": 0, "n_kmers": 0}


@pytest.mark.parametrize("kw", [{"mesh": object()}])
def test_unported_options_raise(tmp_path, kw):
    path = tmp_path / "reads.fq"
    path.write_bytes(_fastq(5, 0))
    # mesh= takes a parallel.Mesh (tests/test_torch_parallel_pipeline.py)
    with pytest.raises(TypeError, match="Mesh"):
        tpipe.count_kmers_fastq(str(path), device="cpu", **kw)
