"""The four pipelines' mesh= paths in the port against the JAX package's
mesh=create_mesh(4) on the 8 virtual CPU devices of tests/conftest.py,
on seeded gzip FASTQ and BED files: the port runs a mesh that repeats
the CPU 4 times, its kernels through their plain versions.  Tables,
matches, bins and stats are equal (integers, exact), to JAX's and to the
port's single-device path; the shard-overflow reruns and the guards
raise and log alike."""
import gzip
import logging

import numpy as np
import pytest
import torch

import jax

from bionumpy_tpu import pipeline as jpipe
from bionumpy_tpu.parallel import create_mesh as jcreate_mesh
from bionumpy_tpu_torch import pipeline as tpipe
from bionumpy_tpu_torch.parallel import create_mesh
# the seeded FASTQ layouts of the packed transport's tests
from test_torch_pipeline import _gz, _members, _unaligned
from test_torch_motif_pipeline import PWM_JAX, PWM_PORT, THRESHOLD

N_DEV = 4
CAP = 1 << 14
ACC_CAP = 1 << 18   # every job's distinct k-mers fit
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def meshes():
    if jax.device_count() < N_DEV:
        pytest.skip("needs 4 (virtual) devices")
    return jcreate_mesh(N_DEV), create_mesh(N_DEV, devices=[CPU] * N_DEV)


def _file(tmp_path, layout, n_members=12):
    members = _members(n_members)
    if layout == "plain":
        path = tmp_path / "reads.fq"
        path.write_bytes(b"".join(members))
        return str(path)
    path = tmp_path / "reads.fq.gz"
    parts = members if layout == "members" else _unaligned(b"".join(members))
    path.write_bytes(_gz(parts))
    return str(path)


def _same_table(got, expect):
    (g, gs), (e, es) = got, expect
    np.testing.assert_array_equal(g.label_codes, e.label_codes)
    np.testing.assert_array_equal(g.counts, e.counts)
    assert g.label_codes.dtype == np.uint64
    assert g.counts.dtype == np.int64
    assert gs == es


@pytest.mark.parametrize("layout,k,target", [
    ("members", 31, 3000),    # several batches of 4 shards each
    ("plain", 21, 20000),
    ("unaligned", 31, 9000),  # members cut mid-entry: the slab path
])
def test_count_kmers_mesh(tmp_path, meshes, layout, k, target):
    jmesh, mesh = meshes
    path = _file(tmp_path, layout)
    kw = dict(cap=CAP, acc_cap=ACC_CAP, target_bases=target)
    got = tpipe.count_kmers_fastq(path, k, mesh=mesh, **kw)
    _same_table(got, jpipe.count_kmers_fastq(path, k, mesh=jmesh, **kw))
    _same_table(got, tpipe.count_kmers_fastq(path, k, device="cpu", **kw))
    assert got[1]["n_reads"] == 12 * 200


def test_count_kmers_mesh_overflow_rerun(tmp_path, meshes, caplog):
    """A shard table past its cap makes the job rerun once at a cap that
    fits: the table, the stats and the logged caps equal JAX's."""
    jmesh, mesh = meshes
    path = _file(tmp_path, "members", 6)
    kw = dict(cap=1 << 8, acc_cap=ACC_CAP, target_bases=6000)
    logs = []
    for run in (lambda: tpipe.count_kmers_fastq(path, 31, mesh=mesh, **kw),
                lambda: jpipe.count_kmers_fastq(path, 31, mesh=jmesh, **kw)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            logs.append(run())
        reruns = [r.getMessage() for r in caplog.records
                  if "shard table overflow" in r.getMessage()]
        assert len(reruns) == 1
        logs.append(reruns[0])
    _same_table(logs[0], logs[2])
    assert logs[1] == logs[3]
    _same_table(logs[0], tpipe.count_kmers_fastq(path, 31, device="cpu",
                                                 cap=CAP, acc_cap=ACC_CAP))


def test_count_kmers_mesh_guard(tmp_path, meshes, monkeypatch):
    """The 2^31-k-mer guard raises for the same inputs in both packages
    (its bound shrunk here to reach it)."""
    jmesh, mesh = meshes
    path = _file(tmp_path, "members", 3)
    messages = []
    for pipe, m in ((tpipe, mesh), (jpipe, jmesh)):
        monkeypatch.setattr(pipe, "_SPILL_LIMIT", 10_000)
        with pytest.raises(ValueError, match="2\\^31 k-mers") as err:
            pipe.count_kmers_fastq(path, 31, cap=CAP, acc_cap=ACC_CAP,
                                   target_bases=3000, mesh=m)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_mesh_of_one_and_empty_file(tmp_path):
    one = create_mesh(1, devices=[CPU])
    path = _file(tmp_path, "members", 4)
    kw = dict(cap=CAP, acc_cap=ACC_CAP, target_bases=5000)
    _same_table(tpipe.count_kmers_fastq(path, 25, mesh=one, **kw),
                tpipe.count_kmers_fastq(path, 25, device="cpu", **kw))
    empty = tmp_path / "zero.fq.gz"
    empty.write_bytes(b"")
    counts, stats = tpipe.count_kmers_fastq(str(empty), 31, mesh=one)
    assert stats == {"n_reads": 0, "n_bases": 0, "n_kmers": 0}
    assert len(counts.label_codes) == 0
    counts, stats = tpipe.count_minimizers_fastq(str(empty), mesh=one)
    assert stats == {"n_reads": 0, "n_bases": 0, "n_windows": 0}


@pytest.mark.parametrize("cap", [CAP, 1 << 8])   # 1 << 8 reruns
def test_count_minimizers_mesh(tmp_path, meshes, cap):
    jmesh, mesh = meshes
    path = _file(tmp_path, "members")
    kw = dict(cap=cap, acc_cap=ACC_CAP, target_bases=4000)
    got = tpipe.count_minimizers_fastq(path, 21, 30, mesh=mesh, **kw)
    _same_table(got, jpipe.count_minimizers_fastq(path, 21, 30, mesh=jmesh,
                                                  **kw))
    _same_table(got, tpipe.count_minimizers_fastq(path, 21, 30,
                                                  device="cpu", **kw))


@pytest.mark.parametrize("layout", ["members", "unaligned"])
def test_motif_matches_mesh(tmp_path, meshes, layout):
    """(read, offset) matches in the shards' read order, equal to JAX's
    and to the single-device scan."""
    jmesh, mesh = meshes
    path = _file(tmp_path, layout)
    kw = dict(cap=1 << 12, target_bases=4000)
    got = tpipe.get_motif_matches_fastq(path, PWM_PORT, THRESHOLD,
                                        mesh=mesh, **kw)
    want = jpipe.get_motif_matches_fastq(path, PWM_JAX, THRESHOLD,
                                         mesh=jmesh, **kw)
    single = tpipe.get_motif_matches_fastq(path, PWM_PORT, THRESHOLD,
                                           device="cpu", **kw)
    for other in (want, single):
        np.testing.assert_array_equal(got[0], other[0])
        np.testing.assert_array_equal(got[1], other[1])
        assert got[2] == other[2]
    assert got[2]["n_matches"] == len(got[0]) > 0


def test_motif_matches_mesh_shard_cap(tmp_path, meshes):
    jmesh, mesh = meshes
    path = _file(tmp_path, "members", 4)
    messages = []
    for run in (lambda: tpipe.get_motif_matches_fastq(
                    path, PWM_PORT, THRESHOLD, cap=4, mesh=mesh),
                lambda: jpipe.get_motif_matches_fastq(
                    path, PWM_JAX, THRESHOLD, cap=4, mesh=jmesh)):
        with pytest.raises(ValueError, match="raise cap") as err:
            run()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def _bed(tmp_path, n=3000):
    rng = np.random.default_rng(23)
    chroms = rng.choice(["chr1", "chr2", "chrX"], n)
    starts = rng.integers(0, 90_000, n)
    stops = starts + rng.integers(1, 900, n)
    path = tmp_path / "iv.bed.gz"
    path.write_bytes(gzip.compress("".join(
        f"{c}\t{s}\t{e}\n" for c, s, e in zip(chroms, starts, stops)
    ).encode(), mtime=0))
    return str(path)


@pytest.mark.parametrize("bin_size", [1000, 77])
def test_binned_pileup_bed_mesh(tmp_path, meshes, bin_size):
    """chrX is left out of the sizes: its records are dropped."""
    jmesh, mesh = meshes
    path = _bed(tmp_path)
    sizes = {"chr1": 100_000, "chr2": 95_001}
    got, stats = tpipe.binned_pileup_bed(path, sizes, bin_size, mesh=mesh)
    want, jstats = jpipe.binned_pileup_bed(path, sizes, bin_size, mesh=jmesh)
    single, sstats = tpipe.binned_pileup_bed(path, sizes, bin_size,
                                             device="cpu")
    assert list(got) == list(want) == list(sizes)
    for name in sizes:
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(got[name], single[name])
        assert got[name].dtype == np.int32
    assert stats == jstats == sstats


def test_mesh_argument_errors(tmp_path):
    """A mesh that is not a Mesh raises TypeError; a device= that is not
    the mesh's lead device raises ValueError."""
    path = _file(tmp_path, "plain", 1)
    bed = _bed(tmp_path, 10)
    mesh = create_mesh(2, devices=[CPU] * 2)
    calls = [
        lambda **kw: tpipe.count_kmers_fastq(path, 21, **kw),
        lambda **kw: tpipe.count_minimizers_fastq(path, **kw),
        lambda **kw: tpipe.get_motif_matches_fastq(path, PWM_PORT,
                                                   THRESHOLD, **kw),
        lambda **kw: tpipe.binned_pileup_bed(bed, {"chr1": 100_000}, **kw),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="Mesh"):
            call(mesh=[CPU, CPU])
        with pytest.raises(ValueError, match="lead device"):
            call(mesh=mesh, device="cuda")
        call(mesh=mesh, device="cpu")
