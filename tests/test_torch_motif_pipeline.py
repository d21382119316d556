"""The port's get_motif_matches_fastq against the JAX package's, on seeded
synthetic FASTQ files in the layouts of tests/test_torch_pipeline.py: the
(read, offset) match positions and the stats dict must be equal (exact
equality: both score in float32 in the same order).  The port runs on
the CPU, its kernel through its plain version; the JAX function runs on
its one-device mesh."""
import gzip

import numpy as np
import pytest

from bionumpy_tpu import pipeline as jpipe
from bionumpy_tpu.sequence.position_weight_matrix import PWM as JaxPWM
from bionumpy_tpu_torch import PWM
from bionumpy_tpu_torch import pipeline as tpipe

# one window and one cap throughout, so the JAX step compiles once per
# batch shape and worker
WINDOW = 11
CAP = 1 << 12


def _counts():
    """JASPAR-style integer counts (0-30) with zero cells (-inf)."""
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 31, (4, WINDOW))
    counts[2, 4] = counts[0, 9] = 0
    return {letter: [int(c) for c in row]
            for letter, row in zip("ACGT", counts)}


PWM_PORT, PWM_JAX = PWM.from_dict(_counts()), JaxPWM.from_dict(_counts())
# about 1% of the windows of uniform random reads score above it
THRESHOLD = 48.0


def _fastq(n_reads, seed, max_len=150):
    """Seeded FASTQ bytes; reads of 0..max_len bases, some empty."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len, n_reads)
    codes = rng.integers(0, 4, int(lengths.sum()))
    seq = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()
    ends = np.cumsum(lengths)
    return "".join(f"@r{seed}.{i}\n{seq[e - n: e]}\n+\n{'I' * n}\n"
                   for i, (n, e) in enumerate(zip(lengths, ends))).encode()


def _members(n_members, n_reads=200):
    return [_fastq(n_reads, s) for s in range(n_members)]


def _gz(parts):
    return b"".join(gzip.compress(p, mtime=0) for p in parts)


def _unaligned(raw, n_pieces=7):
    cuts = np.linspace(0, len(raw), n_pieces + 1).astype(int) + 13
    cuts[0], cuts[-1] = 0, len(raw)
    return [raw[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


def _both(path, threshold=THRESHOLD, **kw):
    got = tpipe.get_motif_matches_fastq(str(path), PWM_PORT, threshold,
                                        cap=CAP, device="cpu", **kw)
    expect = jpipe.get_motif_matches_fastq(str(path), PWM_JAX, threshold,
                                           cap=CAP, **kw)
    return got, expect


def _assert_same(got, expect):
    for g, e in zip(got[:2], expect[:2]):
        np.testing.assert_array_equal(g, e)
        assert g.dtype == np.int64
    assert got[2] == expect[2]


@pytest.mark.parametrize("layout,target", [
    ("members", 6000),      # many batches
    ("members", 40000),     # several members per batch
    ("plain", 20000),
    ("unaligned", 9000),    # members cut mid-entry: the slab path
    ("unaligned", 1 << 25),
])
def test_matches_jax(tmp_path, layout, target):
    members = _members(12)
    if layout == "plain":
        path = tmp_path / "reads.fq"
        path.write_bytes(b"".join(members))
    else:
        path = tmp_path / "reads.fq.gz"
        parts = members if layout == "members" else \
            _unaligned(b"".join(members))
        path.write_bytes(_gz(parts))
    got, expect = _both(path, target_bases=target)
    _assert_same(got, expect)
    stats = got[2]
    assert stats["n_reads"] == 12 * 200
    assert 0.002 < stats["n_matches"] / stats["n_bases"] < 0.05


def test_matches_are_the_numpy_recount(tmp_path):
    """Every window inside its read scoring above the threshold, by a
    float32 numpy accumulation in the same order."""
    raw = _fastq(300, 5)
    path = tmp_path / "reads.fq"
    path.write_bytes(raw)
    rows, offs, stats = tpipe.get_motif_matches_fastq(
        str(path), PWM_PORT, THRESHOLD, cap=CAP, device="cpu")
    m32 = PWM_PORT.matrix.astype(np.float32)
    want = [(r, o) for r, seq in enumerate(raw.split(b"\n")[1::4])
            for o in range(len(seq) - WINDOW + 1)
            if sum((m32[b"ACGT".index(seq[o + j]), j]
                    for j in range(WINDOW)), np.float32(0)) > THRESHOLD]
    assert list(zip(rows.tolist(), offs.tolist())) == want
    assert stats["n_matches"] == len(want) > 0


def test_too_small_cap_raises_like_jax(tmp_path):
    path = tmp_path / "reads.fq.gz"
    path.write_bytes(_gz(_members(3)))
    with pytest.raises(ValueError, match="cap"):
        jpipe.get_motif_matches_fastq(str(path), PWM_JAX, -1e30, cap=CAP)
    with pytest.raises(ValueError, match="cap"):
        tpipe.get_motif_matches_fastq(str(path), PWM_PORT, -1e30, cap=CAP,
                                      device="cpu")


@pytest.mark.parametrize("content", [
    b"",                                           # empty member
    b"@r1\nACGTACGTACGTAC\n+\nIIIIIIIIIIIIII",     # no trailing newline
])
def test_edge_files(tmp_path, content):
    path = tmp_path / "edge.fq.gz"
    path.write_bytes(gzip.compress(content))
    got, expect = _both(path, threshold=-1e30)
    _assert_same(got, expect)


def test_matrix_input_and_unported_options(tmp_path):
    path = tmp_path / "reads.fq"
    path.write_bytes(_fastq(50, 2))
    got = tpipe.get_motif_matches_fastq(str(path), PWM_PORT.matrix,
                                        THRESHOLD, device="cpu")
    want = tpipe.get_motif_matches_fastq(str(path), PWM_PORT, THRESHOLD,
                                         device="cpu")
    _assert_same(got, want)
    with pytest.raises(TypeError, match="Mesh"):
        tpipe.get_motif_matches_fastq(str(path), PWM_PORT, THRESHOLD,
                                      device="cpu", mesh=object())
    with pytest.raises(ValueError, match=r"\(4, w\)"):
        tpipe.get_motif_matches_fastq(str(path), np.zeros((5, 3)),
                                      THRESHOLD, device="cpu")
