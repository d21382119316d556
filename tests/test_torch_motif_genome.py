"""The motif scan over genomes, against the benchmark's plain reference
(portbench/motif_reference.py), on the CPU at small sizes:

- get_motif_matches on both strands (a PWM and its reverse complement)
  for widths 1, 11, 19 and 32, whole and through the blocked path (the
  resident blocks of whole rows and the scan blocks forced small), with
  matches at row starts and ends and rows shorter than the window;
- windows up to 32 in one match-mode launch of kernel 3 a resident
  block, with one wait for its count and one rerun at the exact count
  past the cap; wider windows through the blocked scan of the codes,
  one wait a scan block and its matches compacted at their count;
- the spans a scan opens, the refusal of arrays whose int32 row ends
  would wrap;
- the threshold against a count over every window at w <= 8;
- controls that must read not correct: the minus strand dropped, the
  threshold one float32 ulp higher, the last window of every row lost,
  the reference computed in float16;
- the benchmark cell itself at a small genome, and its two readers.

Scores are float32 sums in the same order in the port and the
reference, so every comparison is exact.  This file imports neither JAX
nor the JAX package; its `cuda` tests run the scans on the card:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_motif_genome.py
"""
import itertools
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bionumpy_tpu_torch as bt
from bionumpy_tpu_torch import instrument
from bionumpy_tpu_torch.ops import (kmers, pwm as ops_pwm, pwm_kernels,
                                     resident)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import motif_reference as M  # noqa: E402
from portbench import reference as R  # noqa: E402
from portbench.harness import run_cell  # noqa: E402
from portbench.registry import HERE, Registry  # noqa: E402

CELL = "motif19-hg38-genome"
WIDE = 40  # past the kernel's 32: the blocked scan of the codes
# p-values that leave tens to hundreds of matches a strand at each width
P_VALUE = {1: 0.3, 11: 1e-2, 19: 1e-3, 32: 1e-3}


def _counts(w, seed):
    return M.motif_counts(w, seed, 100, 0.5)


def _genome(w, seed, plant=None):
    """Seeded rows of 0..3000 bases, some empty or shorter than the
    window; with `plant`, the (w,) consensus written at the start and at
    the end of every row long enough, and twice across its middle."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 3000, 24)
    lengths[[1, 7]] = [0, max(w - 1, 0)]
    lengths[[3, 9]] = [w, w + 1]
    flat = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    if plant is not None:
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        for s, n in zip(starts, lengths):
            if n >= w:
                for at in (s, s + n - w, s + (n - w) // 2):
                    flat[at: at + w] = plant
    return flat, lengths


def _seqs(flat, lengths):
    return bt.EncodedRaggedArray(bt.EncodedArray(flat, bt.DNAEncoding),
                                 lengths)


def _port_keys(seqs, pwms, threshold, cap=1 << 20):
    keys = []
    for strand, pwm in enumerate(pwms):
        m = bt.get_motif_matches(seqs, pwm, threshold, cap=cap,
                                 device="cpu")
        rows = np.repeat(np.arange(len(m.lengths)), m.lengths)
        keys.append((strand << 62) | (rows << 32) | np.asarray(m.ravel()))
    return np.concatenate(keys).astype(np.int64)


def _ref_keys(flat, lengths, matrices, threshold, device="cpu",
             dtype=torch.float32):
    found = M.motif_matches(flat, lengths, matrices, threshold, device,
                            dtype)
    return torch.cat([(s << 62) | (r << 32) | p
                      for s, (r, p) in enumerate(found)])


def _rows_differing(port_keys, ref_keys):
    ones = np.ones(len(port_keys), np.int64)
    return R.compare_output({"keys": port_keys, "counts": ones},
                            {"keys": ref_keys,
                             "counts": torch.ones_like(ref_keys)},
                            "cpu")["rows_differing"]


def _motif(w, seed):
    counts = _counts(w, seed)
    pwm = bt.PWM.from_counts(dict(zip("ACGT", counts.tolist())))
    plus = M.matrix_from_counts(counts)
    np.testing.assert_array_equal(pwm.matrix, plus)
    pwms = [pwm, bt.PWM(M.reverse_complement(pwm.matrix), "ACGT")]
    return pwms, [plus, M.reverse_complement(plus)]


@pytest.fixture
def blocked(monkeypatch):
    """Resident blocks of at most 7000 bases and scan blocks of 64
    positions: every longer row crosses a scan block's end."""
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 7000)
    monkeypatch.setattr(ops_pwm, "SCAN_POSITIONS", 64)


@pytest.mark.parametrize("layout", ["whole", "blocked"])
@pytest.mark.parametrize("w", [1, 11, 19, 32])
def test_both_strands_equal_reference(request, layout, w):
    if layout == "blocked":
        request.getfixturevalue("blocked")
    pwms, matrices = _motif(w, 10 + w)
    consensus = np.argmax(matrices[0], axis=0).astype(np.uint8)
    flat, lengths = _genome(w, 20 + w, plant=consensus)
    threshold = M.threshold(matrices[0], P_VALUE[w])
    seqs = _seqs(flat, lengths)
    got = _port_keys(seqs, pwms, threshold)
    want = _ref_keys(flat, lengths, matrices, threshold)
    assert _rows_differing(got, want) == 0
    np.testing.assert_array_equal(got, want.numpy())
    # the planted consensus matches at the first and the last window of
    # the rows that hold it
    plus = got[got >> 62 == 0]
    pos, row = plus & 0xFFFFFFFF, (plus >> 32) & 0x3FFFFFFF
    assert {0} <= set(pos[row == 0].tolist())
    assert int(lengths[0]) - w in pos[row == 0].tolist()
    assert len(got) > len(plus) > 0
    if layout == "blocked":
        assert len(resident.device_seq_blocks(seqs, "cpu")) > 1


def test_blocked_scan_equals_whole_scan(monkeypatch):
    # a window past the kernel's 32 takes the blocked codes path
    pwms, matrices = _motif(WIDE, 5)
    flat, lengths = _genome(WIDE, 6)
    threshold = M.threshold(matrices[0], 1e-2)
    whole = _port_keys(_seqs(flat, lengths), pwms, threshold)
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 5000)
    monkeypatch.setattr(ops_pwm, "SCAN_POSITIONS", 48)
    split = _port_keys(_seqs(flat, lengths), pwms, threshold)
    np.testing.assert_array_equal(split, whole)
    assert len(whole) > 100


def test_cap_doubles_inside_a_block(blocked):
    pwms, matrices = _motif(WIDE, 3)
    flat, lengths = _genome(WIDE, 4)
    threshold = M.threshold(matrices[0], 0.3)
    instrument.reset()
    got = _port_keys(_seqs(flat, lengths), pwms, threshold, cap=1)
    want = _ref_keys(flat, lengths, matrices, threshold)
    np.testing.assert_array_equal(got, want.numpy())
    rep = instrument.report()
    # one wait a scan block, its matches compacted at their count
    assert rep["D2H-meta"]["calls"] == rep["pwm-compact"]["calls"] == \
        rep["pwm-scan"]["calls"]
    assert "cap-rerun" not in rep
    assert rep["pwm-compact"]["rows"] == len(got)
    assert max(s["rows"] for s in instrument.spans()
               if s["name"] == "pwm-compact") > 1  # past the cap


def test_spans_of_a_scan():
    pwms, matrices = _motif(19, 7)
    flat, lengths = _genome(19, 8)
    threshold = M.threshold(matrices[0], 1e-2)
    seqs = _seqs(flat, lengths)
    bt.get_motif_matches(seqs, pwms[0], threshold, device="cpu")
    instrument.reset()
    m = bt.get_motif_matches(seqs, pwms[0], threshold, device="cpu")
    rep = instrument.report()
    n_matches = int(m.lengths.sum())
    assert rep["get_motif_matches"]["call"] is True
    assert rep["pwm-scan"]["rows"] == -(-len(flat) // 16) * 16
    assert rep["pwm-compact"]["rows"] == n_matches > 0
    assert rep["D2H"]["rows"] == n_matches
    assert rep["D2H"]["bytes"] == 8 * n_matches
    assert "upload" not in rep  # resident since the first call
    # one match-mode launch and one wait for its count: one block
    assert rep["pwm-scan"]["calls"] == rep["D2H-meta"]["calls"] == 1
    assert "cap-rerun" not in rep
    assert rep["pwm-matrix"]["calls"] == rep["result"]["calls"] == 1


def test_result_span_of_a_call():
    """The matches made into rows and in-row positions after the fetch:
    one `result` span a call, under the call span, its rows the matches
    returned; the call's self time and its children's time add up to
    its duration."""
    pwms, matrices = _motif(19, 7)
    flat, lengths = _genome(19, 8)
    threshold = M.threshold(matrices[0], 1e-2)
    seqs = _seqs(flat, lengths)
    bt.get_motif_matches(seqs, pwms[0], threshold, device="cpu")
    for pwm in pwms:
        instrument.reset()
        m = bt.get_motif_matches(seqs, pwm, threshold, device="cpu")
        rep = instrument.report()
        spans = instrument.spans()
        call, = [s for s in spans if s["name"] == "get_motif_matches"]
        result, = [s for s in spans if s["name"] == "result"]
        assert result["parent"] == "get_motif_matches"
        assert result["call"] == call["call"] is not None
        assert result["rows"] == rep["result"]["rows"] == \
            int(m.lengths.sum()) == rep["D2H"]["rows"] > 0
        # the last work of the call: after the fetch, inside the call
        d2h, = [s for s in spans if s["name"] == "D2H"]
        assert d2h["end"] <= result["start"] <= result["end"] <= \
            call["end"]
        children = sum(s["end"] - s["start"] for s in spans
                       if s["parent"] == "get_motif_matches"
                       and s["thread"] == call["thread"])
        assert rep["get_motif_matches"]["self_seconds"] + children == \
            pytest.approx(call["end"] - call["start"], abs=2e-6)
        assert rep["get_motif_matches"]["self_seconds"] < \
            call["end"] - call["start"] - (result["end"] - result["start"])


@pytest.mark.parametrize("cap", [1, 1 << 20])
def test_fused_scan_launches_once_a_block(blocked, cap):
    """Over resident blocks, each takes one match-mode launch and one
    wait for its count; a block with more than `cap` matches takes one
    more launch at the exact count, and the cap carries on."""
    pwms, matrices = _motif(19, 15)
    flat, lengths = _genome(19, 16)
    threshold = M.threshold(matrices[0], 1e-2)
    seqs = _seqs(flat, lengths)
    n_blocks = len(resident.device_seq_blocks(seqs, "cpu"))
    assert n_blocks > 1
    instrument.reset()
    got = _port_keys(seqs, pwms, threshold, cap=cap)
    rep = instrument.report()
    want = _ref_keys(flat, lengths, matrices, threshold)
    np.testing.assert_array_equal(got, want.numpy())
    reruns = rep.get("cap-rerun", {}).get("calls", 0)
    assert rep["D2H-meta"]["calls"] == 2 * n_blocks  # both strands
    assert rep["pwm-scan"]["calls"] == 2 * n_blocks + reruns
    assert rep["pwm-compact"]["rows"] == len(got)
    if cap == 1:
        assert 1 <= reruns < 2 * n_blocks  # the larger cap carries on
    else:
        assert reruns == 0
        # each block scored to its last base rounded up to a word
        per_strand = sum(-(-int(b.n) // 16) * 16 for b in
                         resident.device_seq_blocks(seqs, "cpu"))
        assert rep["pwm-scan"]["rows"] == 2 * per_strand


@pytest.mark.parametrize("w", [1, 3, 6, 8])
def test_threshold_against_every_window(w):
    matrix = M.matrix_from_counts(_counts(w, 30 + w))
    grid = M.GRID
    cells = np.ceil(matrix / grid).astype(np.int64)
    windows = np.array(list(itertools.product(range(4), repeat=w)))
    cols = np.arange(w)
    rounded = cells[windows, cols].sum(axis=1)
    exact = matrix[windows, cols].sum(axis=1)
    least, tail = M.score_tail(matrix, grid)
    above = np.array([(rounded > least + i).sum()
                      for i in range(len(tail))])
    np.testing.assert_array_equal(tail * 4 ** w, above)
    for p in (0.3, 1e-2, 1e-3):
        t = M.threshold(matrix, p, grid)
        i = round(t / grid) - least
        assert (exact > t).mean() <= p
        assert (rounded > least + i).mean() <= p
        if i > 0:
            assert (rounded > least + i - 1).mean() > p


def _control(monkeypatch, fault):
    """rows_differing of a scan with `fault` against the reference."""
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 7000)
    monkeypatch.setattr(ops_pwm, "SCAN_POSITIONS", 64)
    pwms, matrices = _motif(19, 11)
    flat, lengths = _genome(19, 12)
    scores = M.window_scores(torch.from_numpy(flat).to(torch.int64),
                             torch.from_numpy(matrices[0].astype(
                                 np.float32)))
    scores = scores[R.inside_rows(lengths, scores.numel(), 19, "cpu")]
    if fault == "ulp":
        # a threshold just below a window's score; the fault compares at
        # that score, one ulp higher
        threshold = float(np.nextafter(np.float32(scores.max()),
                                       np.float32(-np.inf)))
    else:
        threshold = float(np.quantile(scores.numpy(), 0.5))
    want = _ref_keys(flat, lengths, matrices, threshold,
                     dtype=torch.float16 if fault == "float16"
                     else torch.float32)
    if fault == "ulp":
        threshold = float(np.nextafter(np.float32(threshold),
                                       np.float32(np.inf)))
    if fault == "last_window":
        # the row-end test one base off: the last window of every row lost
        valid = pwm_kernels.valid_windows_plain

        def lossy(ends, n, k, n_true, offset=0):
            return valid(ends, n, k + 1, n_true, offset)
        monkeypatch.setattr(pwm_kernels, "valid_windows_plain", lossy)
    seqs = _seqs(flat, lengths)
    got = _port_keys(seqs, pwms[:1] if fault == "minus" else pwms,
                     threshold)
    return _rows_differing(got, want)


@pytest.mark.parametrize("fault", [None, "minus", "ulp", "last_window",
                                   "float16"])
def test_controls_are_not_correct(monkeypatch, fault):
    differing = _control(monkeypatch, fault)
    assert differing == 0 if fault is None else differing > 0


def test_prepare_packed_refuses_int32_wrap():
    none = np.zeros(0, np.uint8)
    _, ends, _ = kmers.prepare_packed(none, np.array([(1 << 31) - 1]))
    assert int(ends[-1]) == (1 << 31) - 1
    with pytest.raises(ValueError, match="int32"):
        kmers.prepare_packed(none, np.full(3, 1 << 30))


def test_tables_refuse_what_the_scan_takes_in_blocks(monkeypatch):
    pwms, matrices = _motif(11, 13)
    flat, lengths = _genome(11, 14)
    threshold = M.threshold(matrices[0], 1e-2)
    want = _port_keys(_seqs(flat, lengths), pwms, threshold)
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 7000)
    seqs = _seqs(flat, lengths)
    resident.reset_transfer_counters()
    np.testing.assert_array_equal(_port_keys(seqs, pwms, threshold), want)
    blocks = resident.device_seq_blocks(seqs, "cpu")
    assert resident.TRANSFER_COUNT == len(blocks) > 1  # once, cached
    assert [int(b.n) for b in blocks] == [
        int(lengths[r0:r1].sum())
        for r0, r1 in resident.row_blocks(lengths, 7000)]
    assert max(b.n for b in blocks) <= 7000
    # count_kmers takes the same blocks in passes (ops/kmers.blocked_table);
    # count_minimizers_with_gc in one batch still refuses them
    table = bt.count_kmers(seqs, 31, device="cpu")
    keys, counts = R.kmer_table(flat, lengths, 31, "cpu")
    np.testing.assert_array_equal(table.label_codes.view(np.int64),
                                  keys.numpy())
    np.testing.assert_array_equal(table.counts, counts.numpy())
    assert resident.TRANSFER_COUNT == len(blocks)  # the blocks, reused
    with pytest.raises(ValueError, match="int32"):
        bt.count_minimizers_with_gc(seqs, 21, 30, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        resident.row_blocks(lengths, 2000)


def _tiny_registry(tmp_path):
    """The committed cell over a small genome: the same file with 25
    rows of 1-30,000 bases."""
    os.makedirs(tmp_path / "configs")
    with open(os.path.join(HERE, "configs", "motif-ctcf19-hg38.json")) as f:
        config = json.load(f)
    sizes = config["genome"]["chromosome_sizes"]
    config["genome"]["chromosome_sizes"] = {
        name: max(n // 10_000, 1) for name, n in sizes.items()}
    config["motif"]["p_value"] = 1e-3
    (tmp_path / "configs" / "motif-ctcf19-hg38.json").write_text(
        json.dumps(config))
    return Registry([str(tmp_path), HERE])


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_a_small_genome(tmp_path, trace):
    reg = _tiny_registry(tmp_path)
    res = run_cell(reg, CELL, 3_000_000_019, 0.3, trace, "cpu",
                   time.perf_counter(), log=lambda m: None)
    assert res["correct"] and res["failed"] == 0, res
    assert res["checks"]["rows_differing"]["value"] == 0
    if trace:
        positions = res["metrics"]["scored_positions_per_base"]["value"]
        assert 2.0 <= positions < 2.001
        assert "pwm_scores_roofline" not in res["metrics"]  # no kernel
        assert res["metrics"]["result_ms_per_job"]["value"] > 0
        # the CPU fetch is pageable: no block taken
        assert "fetch_alloc_ms_per_job" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"setup_s", "job_mbases_per_s"}


def test_roofline_reader():
    read = Registry([HERE]).metric("pwm_scores_roofline")
    peaks = {"hbm_bytes_per_s": 3.35e12, "int32_ops_per_s": 67e12}
    jobs = [SimpleNamespace(n_bases=10 ** 9)] * 2
    config = {"motif": {"width": 19, "strands": ["+", "-"]}}
    kernel = ("void (anonymous namespace)::pwm_scores_kernel<19>"
              "(unsigned int const*, long long, float const*, float*)")
    events = [(kernel, "kernel"), ("other", "kernel"),
              (kernel, "gpu_memcpy")]
    trace = SimpleNamespace(seconds=lambda keep: 0.01 * sum(
        bool(keep(n, c)) for n, c in events))
    ctx = SimpleNamespace(trace=trace, jobs=jobs, config=config,
                          peaks=peaks)
    # by operations at w = 19: 105 a position, over 0.01 s
    assert read.read(ctx) == pytest.approx(
        100 * 4 * 10 ** 9 * 105 / 67e12 / 0.01)
    ctx.trace = SimpleNamespace(seconds=lambda keep: 0.0)
    assert read.read(ctx) is None


def test_scored_positions_reader():
    read = Registry([HERE]).metric("scored_positions_per_base").read
    ctx = SimpleNamespace(stages={"pwm-scan": {"rows": 4096}}, gbases=2e-6)
    assert read(ctx) == pytest.approx(2.048)
    assert read(SimpleNamespace(stages={}, gbases=1.0)) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [11, 19, 32])
def test_blocked_scan_on_card_equals_reference(cuda, monkeypatch, w):
    """Resident blocks of at most 2^21 bases and scan blocks of 2^16
    positions over 8.4 M bases: pwm_scores_kernel over slices of the
    resident words, against the reference on the card."""
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 1 << 21)
    monkeypatch.setattr(ops_pwm, "SCAN_POSITIONS", 1 << 16)
    pwms, matrices = _motif(w, 40 + w)
    rng = np.random.default_rng(50 + w)
    lengths = rng.integers(1, 1_900_000, 8)
    lengths[3] = w - 1
    flat = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    threshold = M.threshold(matrices[0], 1e-4)
    seqs = _seqs(flat, lengths)
    keys = []
    for strand, pwm in enumerate(pwms):
        m = bt.get_motif_matches(seqs, pwm, threshold, device=cuda)
        rows = np.repeat(np.arange(len(m.lengths)), m.lengths)
        keys.append((strand << 62) | (rows << 32) | np.asarray(m.ravel()))
    got = np.concatenate(keys).astype(np.int64)
    want = _ref_keys(flat, lengths, matrices, threshold, cuda)
    np.testing.assert_array_equal(got, want.cpu().numpy())
    assert len(resident.device_seq_blocks(seqs, cuda)) > 1
    assert len(got) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 1 << 20])
def test_fused_scan_on_card_launches_once_a_block(cuda, monkeypatch, cap):
    """Resident blocks of at most 2^21 bases over 8.4 M bases at w = 19:
    one match-mode launch of kernel 3 and one wait for its count a
    block, one more launch where a block passes the cap, no scores-mode
    launch; equal to the reference on the card."""
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 1 << 21)
    pwms, matrices = _motif(19, 61)
    rng = np.random.default_rng(62)
    lengths = rng.integers(1, 1_900_000, 8)
    lengths[5] = 18
    flat = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    threshold = M.threshold(matrices[0], 1e-4)
    seqs = _seqs(flat, lengths)
    n_blocks = len(resident.device_seq_blocks(seqs, cuda))
    assert n_blocks > 1
    pwm_kernels.reset_launches()
    instrument.reset()
    keys = []
    for strand, pwm in enumerate(pwms):
        m = bt.get_motif_matches(seqs, pwm, threshold, cap=cap, device=cuda)
        rows = np.repeat(np.arange(len(m.lengths)), m.lengths)
        keys.append((strand << 62) | (rows << 32) | np.asarray(m.ravel()))
    rep = instrument.report()
    got = np.concatenate(keys).astype(np.int64)
    want = _ref_keys(flat, lengths, matrices, threshold, cuda)
    np.testing.assert_array_equal(got, want.cpu().numpy())
    reruns = rep.get("cap-rerun", {}).get("calls", 0)
    assert pwm_kernels.LAUNCHES["pwm_scores_kernel"] == 0
    assert pwm_kernels.LAUNCHES["pwm_scores_kernel.match"] == \
        rep["pwm-scan"]["calls"] == 2 * n_blocks + reruns
    assert rep["D2H-meta"]["calls"] == 2 * n_blocks
    assert (reruns >= 1) == (cap == 1)
    assert len(got) > 500


@pytest.mark.cuda
def test_second_scan_of_a_genome_reads_no_codes(cuda):
    """Two scans of one array of more than 2^31 bases, held as two
    resident blocks: the same matches, and only the first call reads the
    array's codes on the host; the second takes their largest from the
    array's cache."""
    pwms, matrices = _motif(19, 71)
    lengths = np.array([1 << 30, 1 << 30, 1 << 20])
    n = int(lengths.sum())
    flat = np.frombuffer(np.random.default_rng(72).bytes(n), np.uint8) & 3
    seqs = _seqs(flat, lengths)
    threshold = M.threshold(matrices[0], 1e-4)
    instrument.reset()
    first = bt.get_motif_matches(seqs, pwms[0], threshold, device=cuda)
    second = bt.get_motif_matches(seqs, pwms[0], threshold, device=cuda)
    assert len(resident.device_seq_blocks(seqs, cuda)) == 2
    np.testing.assert_array_equal(first.lengths, second.lengths)
    np.testing.assert_array_equal(first.ravel(), second.ravel())
    assert int(first.lengths.sum()) > 100_000
    assert [s["rows"] for s in instrument.spans()
            if s["name"] == "check-codes"] == [n, 0]
    assert instrument.report()["check-codes-cached"]["calls"] == 1
