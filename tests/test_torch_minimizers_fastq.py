"""The port's count_minimizers_fastq against the JAX package's (which runs
through a one-device mesh), on the seeded FASTQ layouts of
test_torch_pipeline.py: hashes, counts, dtypes and the stats dict must be
equal.  The port runs on the CPU, its kernels through their plain
versions."""
import gzip

import numpy as np
import pytest

from bionumpy_tpu import pipeline as jpipe
from bionumpy_tpu_torch import pipeline as tpipe
from bionumpy_tpu_torch.sequence.minimizers import count_minimizers
# the seeded FASTQ layouts of the packed transport's tests
from test_torch_pipeline import _fastq, _gz, _members, _unaligned

# one batch table size and one accumulator size throughout, so the JAX
# side compiles each of its programs once per worker
CAP = 1 << 14
ACC_CAP = 1 << 16


def _both(path, **kw):
    kw.setdefault("cap", CAP)
    kw.setdefault("acc_cap", ACC_CAP)
    got = tpipe.count_minimizers_fastq(str(path), device="cpu", **kw)
    expect = jpipe.count_minimizers_fastq(str(path), **kw)
    return got, expect


def _assert_same(got, expect):
    (g, gs), (e, es) = got, expect
    np.testing.assert_array_equal(g.label_codes, e.label_codes)
    np.testing.assert_array_equal(g.counts, e.counts)
    assert g.label_codes.dtype == np.uint64 == e.label_codes.dtype
    assert g.counts.dtype == np.int64 == np.asarray(e.counts).dtype
    assert str(g.encoding) == str(e.encoding)
    assert gs == es


@pytest.mark.parametrize("layout,k,w,target", [
    ("members", 21, 30, 6000),     # many batches, one fold each
    ("members", 5, 12, 40000),     # several members per batch
    ("plain", 21, 30, 20000),
    ("unaligned", 21, 30, 9000),   # members cut mid-entry: the slab path
    ("unaligned", 15, 15, 1 << 25),
])
def test_matches_jax(tmp_path, layout, k, w, target):
    members = _members(12)
    if layout == "plain":
        path = tmp_path / "reads.fq"
        path.write_bytes(b"".join(members))
    else:
        path = tmp_path / "reads.fq.gz"
        parts = members if layout == "members" else \
            _unaligned(b"".join(members))
        path.write_bytes(_gz(parts))
    got, expect = _both(path, k=k, window_size=w, target_bases=target)
    _assert_same(got, expect)
    assert got[1]["n_reads"] == 12 * 200 and got[1]["n_windows"] > 0


def test_equals_count_minimizers_on_the_same_reads(tmp_path):
    """The file's table is the one count_minimizers gives for its reads
    as one array, and n_windows is its total."""
    import bionumpy_tpu_torch as tbnp
    raw = b"".join(_members(4))
    path = tmp_path / "reads.fq.gz"
    path.write_bytes(_gz([raw]))
    table, stats = tpipe.count_minimizers_fastq(str(path), 21, 30,
                                                device="cpu",
                                                target_bases=5000)
    reads = raw.decode().split("\n")[1::4]
    want = count_minimizers(tbnp.as_encoded_array(reads, tbnp.DNAEncoding),
                            21, 30, device="cpu")
    np.testing.assert_array_equal(table.label_codes, want.label_codes)
    np.testing.assert_array_equal(table.counts, want.counts)
    assert stats["n_windows"] == int(want.counts.sum())
    assert stats["n_bases"] == sum(len(r) for r in reads)


def test_cap_overflow_reruns_like_jax(tmp_path, caplog):
    path = tmp_path / "reads.fq.gz"
    path.write_bytes(_gz(_members(3)))
    got, expect = _both(path, k=21, window_size=30, cap=1 << 8,
                        target_bases=20000)
    _assert_same(got, expect)
    assert "count_minimizers_fastq: batch table overflow" in caplog.text


def test_acc_overflow_raises_like_jax(tmp_path):
    path = tmp_path / "reads.fq.gz"
    path.write_bytes(_gz(_members(3, n_reads=100)))
    kw = dict(k=21, window_size=30, cap=CAP, acc_cap=500,
              target_bases=6000)
    with pytest.raises(jpipe.AccOverflow):
        jpipe.count_minimizers_fastq(str(path), **kw)
    with pytest.raises(tpipe.AccOverflow) as err:
        tpipe.count_minimizers_fastq(str(path), device="cpu", **kw)
    assert int(err.value.meta_h[0]) <= CAP  # no batch overflowed its cap


@pytest.mark.parametrize("content,expect_reads", [
    (b"", 0),                                           # empty member
    (b"@r1\nACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIII", 1),  # no trailing \n
    (b"@r1\nACGT\n+\nIIII\n", 1),                       # shorter than w
])
def test_edge_files(tmp_path, content, expect_reads):
    path = tmp_path / "edge.fq.gz"
    path.write_bytes(gzip.compress(content))
    got, expect = _both(path, k=5, window_size=12)
    _assert_same(got, expect)
    assert got[1]["n_reads"] == expect_reads


def test_zero_byte_file(tmp_path):
    path = tmp_path / "zero.fq.gz"
    path.write_bytes(b"")
    got = tpipe.count_minimizers_fastq(str(path), device="cpu")
    assert got[1] == {"n_reads": 0, "n_bases": 0, "n_windows": 0}
    assert len(got[0].label_codes) == 0


def test_unported_and_bad_options_raise(tmp_path):
    path = tmp_path / "reads.fq"
    path.write_bytes(_fastq(5, 0))
    with pytest.raises(TypeError, match="Mesh"):
        tpipe.count_minimizers_fastq(str(path), device="cpu", mesh=object())
    with pytest.raises(ValueError, match="window_size"):
        tpipe.count_minimizers_fastq(str(path), 21, 20, device="cpu")
