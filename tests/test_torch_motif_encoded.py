"""The port's motif scans on encoded arrays (sequence/position_weight_matrix
.py, ops/pwm.pwm_scores and pwm_best_scores, io/motifs.read_motif)
against the JAX package's, on the CPU: the same seeded sequences and
matrices through both.  Float32 sums add the cells in the same order, so
scores are compared exactly (float64 on the host path, float32 cast to
float64 on the device path), -inf cells included; match positions and
read motifs exactly."""
import numpy as np
import pytest
import torch

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu.io.motifs import read_motif as jread_motif
from bionumpy_tpu.ops import pwm as jpwm
from bionumpy_tpu.sequence import position_weight_matrix as jpw
from bionumpy_tpu_torch import instrument
from bionumpy_tpu_torch.encodings import AlphabetEncoding
from bionumpy_tpu_torch.io.motifs import Motif, read_motif
from bionumpy_tpu_torch.ops import pwm as tpwm
from bionumpy_tpu_torch.ops import resident
from bionumpy_tpu_torch.sequence import position_weight_matrix as tpw

PROTEIN = "ACDEFGHIKLMNPQRSTVWY"


def _counts(seed, alphabet="ACGT", window=11, zeros=3):
    """Seeded JASPAR-style counts 0-30 with a few zeros (-inf cells)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 31, (len(alphabet), window))
    counts[rng.integers(0, len(alphabet), zeros),
           rng.integers(0, window, zeros)] = 0
    return {letter: [int(c) for c in row]
            for letter, row in zip(alphabet, counts)}


def _pwms(seed, alphabet="ACGT", window=11):
    counts = _counts(seed, alphabet, window)
    return tbnp.PWM.from_dict(counts), jpw.PWM.from_dict(counts)


def _strings(n_bases, seed, alphabet="ACGT", window=11):
    """Rows of every length 0..window+3, then random rows of up to 300
    letters until about n_bases."""
    rng = np.random.default_rng(seed)
    lengths = list(range(window + 4))
    while sum(lengths) < n_bases:
        lengths.append(int(rng.integers(0, 300)))
    letters = np.array(list(alphabet))
    return ["".join(rng.choice(letters, n)) for n in lengths]


def _pair(strings, alphabet="ACGT"):
    if alphabet == "ACGT":
        return (tbnp.as_encoded_array(strings, tbnp.DNAEncoding),
                jbnp.as_encoded_array(strings, jbnp.DNAEncoding))
    from bionumpy_tpu.encodings import AlphabetEncoding as JAlphabet
    return (tbnp.as_encoded_array(strings, AlphabetEncoding(alphabet)),
            jbnp.as_encoded_array(strings, JAlphabet(alphabet)))


def _assert_same_scores(got, want):
    assert type(got).__name__ == type(want).__name__
    if hasattr(want, "lengths"):
        np.testing.assert_array_equal(got.lengths, want.lengths)
        got, want = got.ravel(), want.ravel()
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.float64


# ---- ops -------------------------------------------------------------------

def _codes(seed, n, alphabet_size, w):
    rng = np.random.default_rng(seed)
    codes = np.zeros(n + w + 16, np.uint8)
    codes[:n] = rng.integers(0, alphabet_size, n)
    lengths = rng.integers(0, 60, n)
    lengths = lengths[np.cumsum(lengths) <= n]
    lengths = np.append(lengths, n - lengths.sum())
    dist = np.zeros(len(codes), np.int32)
    ends = np.cumsum(lengths)
    dist[:n] = np.repeat(ends, lengths) - np.arange(n)
    return codes, dist


@pytest.mark.parametrize("alphabet,w", [("ACGT", 1), ("ACGT", 11),
                                        ("ACGT", 40), (PROTEIN, 9)])
def test_pwm_scores_on_codes_equal_jax(alphabet, w):
    """Bit-equal float32 sums, -inf cells included; a 20-letter protein
    matrix and a window past the CUDA kernel's 32 run here too."""
    codes, dist = _codes(len(alphabet) + w, 3000, len(alphabet), w)
    matrix = _pwms(w, alphabet, w)[0].matrix.astype(np.float32)
    got = tpwm.pwm_scores(torch.from_numpy(codes), torch.from_numpy(matrix),
                          w).numpy()
    want = np.asarray(jpwm.pwm_scores(codes, matrix, w))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and np.isneginf(got).any()
    best = tpwm.pwm_best_scores(torch.from_numpy(codes),
                                torch.from_numpy(dist),
                                torch.from_numpy(matrix), w).numpy()
    np.testing.assert_array_equal(
        best, np.asarray(jpwm.pwm_best_scores(codes, dist, matrix, w)))
    assert np.isneginf(best[dist < w]).all()


# ---- the encoded-array API -------------------------------------------------

@pytest.mark.parametrize("n_bases", [(1 << 15) - 700, (1 << 15) + 700])
def test_get_motif_scores_both_sides_of_the_switch(n_bases):
    """Below 2^15 bases both score on the host in float64; above, on a
    device in float32, returned as float64: the two packages agree on
    either side, and the two sides differ in their low bits."""
    pwm, jax_pwm = _pwms(1)
    seqs, jseqs = _pair(_strings(n_bases, 2))
    assert (seqs.size > 1 << 15) == (n_bases > 1 << 15)
    got = tbnp.get_motif_scores(seqs, pwm, device="cpu")
    _assert_same_scores(got, jpw.get_motif_scores(jseqs, jax_pwm))
    assert np.isneginf(got.ravel()).any()
    assert list(got.lengths[:15]) == [0] * 11 + [1, 2, 3, 4]
    host = pwm.calculate_scores(seqs.ravel())
    flat = np.asarray(got.ravel())
    starts = np.insert(np.cumsum(seqs.lengths), 0, 0)[:-1]
    keep = np.concatenate([np.arange(s, s + n) for s, n in
                           zip(starts, got.lengths)])
    if n_bases < 1 << 15:
        np.testing.assert_array_equal(flat, host[keep])
    else:
        finite = np.isfinite(flat)
        np.testing.assert_allclose(flat[finite], host[keep][finite],
                                   rtol=1e-5, atol=1e-5)
        assert not np.array_equal(flat, host[keep])


def test_get_motif_scores_protein_and_flat_inputs():
    pwm, jax_pwm = _pwms(3, PROTEIN, 9)
    seqs, jseqs = _pair(_strings((1 << 15) + 500, 4, PROTEIN, 9), PROTEIN)
    _assert_same_scores(tbnp.get_motif_scores(seqs, pwm, device="cpu"),
                        jpw.get_motif_scores(jseqs, jax_pwm))
    flat = "".join(_strings(400, 5))
    pwm, jax_pwm = _pwms(6)
    got = tbnp.get_motif_scores(flat, pwm, device="cpu")
    _assert_same_scores(got, jpw.get_motif_scores(flat, jax_pwm))
    assert len(got) == len(flat) - 10
    pwm1, jax_pwm1 = _pwms(7, window=1)
    seqs, jseqs = _pair(_strings(2000, 8, window=1))
    _assert_same_scores(tbnp.get_motif_scores(seqs, pwm1, device="cpu"),
                        jpw.get_motif_scores(jseqs, jax_pwm1))


@pytest.mark.parametrize("cap", [1 << 20, 8])
@pytest.mark.parametrize("w", [6, 11, 40])
def test_get_motif_matches_equal_jax(cap, w):
    """cap = 8 is below the match count: both compact again at twice the
    cap until the matches fit.  w = 40 is past the CUDA kernel's 32 and
    takes the codes scan."""
    pwm, jax_pwm = _pwms(w, window=w)
    seqs, jseqs = _pair(_strings(12000, 9, window=w))
    scores = pwm.calculate_scores(seqs.ravel())
    threshold = float(np.percentile(scores[np.isfinite(scores)], 99))
    got = tbnp.get_motif_matches(seqs, pwm, threshold, cap=cap, device="cpu")
    want = jpw.get_motif_matches(jseqs, jax_pwm, threshold, cap=cap)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.ravel(), want.ravel())
    assert np.asarray(got.ravel()).dtype == np.int64
    assert int(got.lengths.sum()) > 8


def test_flat_input_and_alphabet_checks_like_jax():
    pwm, jax_pwm = _pwms(10, window=4)
    s = "TTACGTTACGAAC" * 3
    got = tbnp.get_motif_matches(tbnp.as_encoded_array(s, tbnp.DNAEncoding),
                                 pwm, 0.5, device="cpu")
    want = jpw.get_motif_matches(jbnp.as_encoded_array(s, jbnp.DNAEncoding),
                                 jax_pwm, 0.5)
    np.testing.assert_array_equal(got.ravel(), want.ravel())
    five = tbnp.as_encoded_array(["ACGTN"], AlphabetEncoding("ACGTN"))
    with pytest.raises(ValueError, match="Cannot calculate pwm"):
        pwm.as_valid_encoded_array(five)
    with pytest.raises(ValueError, match="4-letter"):
        protein = tbnp.as_encoded_array(["ACDE"], AlphabetEncoding(PROTEIN))
        tbnp.get_motif_matches(protein, _pwms(1, PROTEIN, 3)[0], 0.0,
                               device="cpu")
    for p in (pwm, jax_pwm):  # a list of ints is no sequence
        with pytest.raises(TypeError):
            p.calculate_scores([0, 1, 2])
    with pytest.raises(ValueError):
        pwm.calculate_scores("ACGN")


CLEAN = ["ACGTACGTTA", "", "CCGTA", "GATTACAGGT"]
WITH_N = CLEAN[:-1] + ["GATTNCAGGT"]


def _check(pwm, seqs):
    """`pwm`'s check of `seqs`'s codes: its ValueError's message, or None
    where it passes."""
    try:
        pwm.as_valid_encoded_array(seqs)
    except ValueError as err:
        return str(err)
    return None


def _write_n(seqs, case):
    """An N into row 0, base 2: through __setitem__, or through a view of
    the codes (with the port's array invalidated after it)."""
    if case == "setitem":
        seqs[0, 2] = "N"
    else:
        seqs.ravel().raw()[2] = 4
        if isinstance(seqs, tbnp.EncodedRaggedArray):
            resident.invalidate(seqs)


@pytest.mark.parametrize("case", ["N held", "clean", "setitem",
                                  "view write and invalidate", "slice"])
def test_code_check_once_per_array(case):
    """The port checks an array's codes once and keeps its largest code
    until __setitem__ or invalidate; a slice is checked afresh.  Each
    check decides as the JAX package's does, with the same message, and
    reads the array's codes on the host only when nothing is cached."""
    strings = WITH_N if case in ("N held", "slice") else CLEAN
    pwm, jax_pwm = _pwms(20, window=3)
    seqs, jseqs = _pair(strings, "ACGTN")
    n = seqs.size
    read = resident.CODES_READ
    first = _check(pwm, seqs)
    assert first == _check(jax_pwm, jseqs)
    assert resident.CODES_READ - read == n
    if case in ("setitem", "view write and invalidate"):
        for s in (seqs, jseqs):
            _write_n(s, case)
    if case == "slice":
        seqs, jseqs = seqs[:-1], jseqs[:-1]
    read = resident.CODES_READ
    second = _check(pwm, seqs)
    assert second == _check(jax_pwm, jseqs)
    failed = first is not None, second is not None
    codes_read = resident.CODES_READ - read
    if case == "N held":
        assert failed == (True, True) and codes_read == 0
    elif case == "clean":
        assert failed == (False, False) and codes_read == 0
    elif case == "slice":
        assert failed == (True, False) and codes_read == seqs.size < n
    else:
        assert failed == (False, True) and codes_read == n
    for said in (first, second):
        assert said is None or said.startswith("Cannot calculate pwm")


@pytest.mark.parametrize("alphabet", ["ACGT", "ACGTN"])
def test_second_motif_call_reads_no_codes(alphabet):
    """Two get_motif_matches calls on one array: the first reads its codes
    in the `check-codes` span, the second reads none and counts one
    `check-codes-cached`.  An ACGT array gives the JAX package's matches
    both times; an ACGTN array holding an N raises its ValueError both
    times."""
    pwm, jax_pwm = _pwms(21, window=3)
    strings = CLEAN if alphabet == "ACGT" else WITH_N
    seqs, jseqs = _pair(strings, alphabet)
    instrument.reset()
    for call in range(2):
        if alphabet == "ACGT":
            got = tbnp.get_motif_matches(seqs, pwm, 0.5, device="cpu")
            want = jpw.get_motif_matches(jseqs, jax_pwm, 0.5)
            np.testing.assert_array_equal(got.lengths, want.lengths)
            np.testing.assert_array_equal(got.ravel(), want.ravel())
        else:
            with pytest.raises(ValueError) as jax_err:
                jpw.get_motif_matches(jseqs, jax_pwm, 0.5)
            with pytest.raises(ValueError, match="Cannot calculate pwm") \
                    as err:
                tbnp.get_motif_matches(seqs, pwm, 0.5, device="cpu")
            assert str(err.value) == str(jax_err.value)
    rows = [s["rows"] for s in instrument.spans()
            if s["name"] == "check-codes"]
    assert rows == [seqs.size, 0]
    assert instrument.report()["check-codes-cached"] == {
        "seconds": 0.0, "calls": 1, "self_seconds": 0.0, "rows": 1}


def test_position_weight_matrix_rolls_like_jax():
    pwm, jax_pwm = _pwms(11, window=5)
    seqs, jseqs = _pair(_strings(3000, 12, window=5))
    got = tpw.PositionWeightMatrix(pwm).rolling_window(seqs)
    want = jpw.PositionWeightMatrix(jax_pwm).rolling_window(jseqs)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.ravel(), want.ravel())
    window = "ACGTA"
    assert pwm.calculate_score(window) == jax_pwm.calculate_score(window)


def test_one_upload_across_kmer_minimizer_and_motif_calls():
    pwm, _ = _pwms(13)
    seqs, _ = _pair(_strings((1 << 15) + 300, 14))
    resident.reset_transfer_counters()
    tbnp.count_kmers(seqs, 31, device="cpu")
    tbnp.get_minimizers(seqs, 21, 30, device="cpu")
    tbnp.count_minimizers_with_gc(seqs, 21, 30, device="cpu")
    tbnp.get_motif_matches(seqs, pwm, 5.0, device="cpu")
    tbnp.get_motif_scores(seqs, pwm, device="cpu")
    assert resident.TRANSFER_COUNT == 1


def _write_motif(tmp_path, counts, suffix):
    path = tmp_path / f"motif{suffix}"
    if suffix == ".jaspar":
        path.write_text(">MA0000.1 TEST\n" + "".join(
            f"{letter}  [ {' '.join(f'{c:5d}' for c in row)} ]\n"
            for letter, row in counts.items()))
    else:
        letters = list(counts)
        path.write_text(",".join(letters) + "\n" + "".join(
            ",".join(str(counts[a][j]) for a in letters) + "\n"
            for j in range(len(counts[letters[0]]))))
    return str(path)


@pytest.mark.parametrize("suffix", [".jaspar", ".csv"])
def test_read_motif_equals_jax(tmp_path, suffix):
    counts = _counts(15, window=8)
    path = _write_motif(tmp_path, counts, suffix)
    got, want = read_motif(path), jread_motif(path)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert got.alphabet == want.alphabet == "ACGT"
    np.testing.assert_array_equal(got.matrix,
                                  tbnp.PWM.from_dict(counts).matrix)
    assert np.isneginf(got.matrix).sum() >= 2
    assert tbnp.read_motif is read_motif
    m = Motif("ACGT", got.matrix)
    assert m.alphabet == "ACGT" and m.matrix is got.matrix
