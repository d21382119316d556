"""The port's motif scan against the JAX package's, on seeded inputs:

- pwm_scores_plain (the plain version of the pwm_scores kernel) against
  the Pallas `_pwm_block_kernel` in interpret mode and against the XLA
  pwm_scores_packed.  Tolerance: exact.  All three add the same float32
  values in the same order (j = 0..w-1 from 0.0), so their scores agree
  bit for bit, -inf cells included.
- pwm_match_compact against JAX's: positions and match count, exact.
- PWM constructors, scores and the JASPAR reader against JAX's: equal
  float64 matrices and scores (the same numpy operations), -inf cells
  included.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bionumpy_tpu.io.jaspar import read_jaspar_matrix as jax_read_jaspar
from bionumpy_tpu.ops import pallas_pwm as jpp
from bionumpy_tpu.ops import pwm as jpwm
from bionumpy_tpu.sequence.position_weight_matrix import PWM as JaxPWM
from bionumpy_tpu_torch import PWM, read_jaspar_matrix
from bionumpy_tpu_torch.ops import pwm as tpwm
from bionumpy_tpu_torch.ops import pwm_kernels as pk
from bionumpy_tpu_torch.ops.kmers import prepare_packed

WIDTHS = [1, 4, 11, 16, 17, 31, 32]


def _batch(seed, n_rows=400):
    """Seeded reads of 0..300 bases, some empty or shorter than any
    window, packed as the pipeline packs them; the row axis padded by
    repeating the last end."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 301, n_rows)
    lengths[::9] = rng.integers(0, 12, len(lengths[::9]))
    codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    words, ends, n = prepare_packed(codes, lengths)
    ends = np.concatenate([ends, np.full(112, ends[-1], np.int32)])
    return codes, lengths, words, ends, n


def _matrix(seed, window):
    """float32 (4, window) log-likelihoods with -inf cells."""
    rng = np.random.default_rng(100 + seed)
    m = rng.normal(0, 1, (4, window)).astype(np.float32)
    m[rng.integers(0, 4, max(window // 4, 1)),
      rng.integers(0, window, max(window // 4, 1))] = -np.inf
    return m


def _port_scores(words, matrix, window):
    return pk.pwm_scores(torch.from_numpy(words.view(np.int32)),
                         torch.from_numpy(matrix), window).numpy()


@pytest.mark.parametrize("window", WIDTHS)
def test_plain_scores_equal_xla(window):
    _, _, words, _, _ = _batch(window)
    matrix = _matrix(window, window)
    got = _port_scores(words, matrix, window)
    want = np.asarray(jpwm.pwm_scores_packed(
        jnp.asarray(words), jnp.asarray(matrix), window))
    assert len(got) == (len(words) - 2) * 16
    # every non-halo position, exactly
    np.testing.assert_array_equal(got, want[: len(got)])
    assert np.isneginf(got).any()


@pytest.mark.parametrize("window", WIDTHS)
def test_plain_scores_equal_pallas_interpret(window):
    """The Pallas kernel in interpret mode, driven as
    tests/test_pwm_device.py drives it; compared over full windows."""
    from jax.experimental import pallas as pl
    _, _, words, _, n = _batch(50 + window)
    matrix = _matrix(50 + window, window)
    n_words = words.shape[0] - 2
    n_blocks = n_words // jpp.WORDS_PER_BLOCK
    shifted = [jnp.asarray(words[i: n_words + i]).reshape(n_blocks, 1, -1)
               for i in range(3)]
    word_spec = pl.BlockSpec((1, 1, jpp.WORDS_PER_BLOCK),
                             lambda i: (i, 0, 0))
    out = pl.pallas_call(
        partial(jpp._pwm_block_kernel, window=window),
        grid=(n_blocks,),
        in_specs=[word_spec] * 3 + [pl.BlockSpec((4, window),
                                                 lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, jpp.WORD_BASES, jpp.WORDS_PER_BLOCK),
                               lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(
            (n_blocks, jpp.WORD_BASES, jpp.WORDS_PER_BLOCK), jnp.float32),
        interpret=True,
    )(*shifted, jnp.asarray(matrix))
    want = np.asarray(out.transpose(0, 2, 1).reshape(-1))
    v = n - window + 1
    got = _port_scores(words, matrix, window)
    np.testing.assert_array_equal(got[:v], want[:v])


def test_plain_scores_equal_numpy_recount():
    """Against the float32 host accumulation of tests/test_pwm_device.py
    over the flat codes (windows past the data's end trimmed)."""
    codes, _, words, _, n = _batch(7)
    matrix = _matrix(7, 11)
    want = np.zeros(n, np.float32)
    for j in range(11):
        want[: n - j] += matrix[:, j][codes[j:]]
    np.testing.assert_array_equal(
        _port_scores(words, matrix, 11)[: n - 10], want[: n - 10])


@pytest.mark.parametrize("window,cap,n_cut", [
    (11, 1 << 14, 0),
    (11, 1 << 14, 1000),   # n_true below the last row end
    (11, 37, 0),           # cap below the match count
    (1, 1 << 14, 0),
    (32, 1 << 14, 0),
])
def test_match_compact_equals_jax(window, cap, n_cut):
    _, _, words, ends, n = _batch(200 + window)
    matrix = _matrix(200 + window, window)
    n_true = n - n_cut
    scores = _port_scores(words, matrix, window)
    # w = 1 scores take four values: keep the top one or two as hits
    q = 0.5 if window == 1 else 0.97
    threshold = np.float32(np.quantile(scores[np.isfinite(scores)], q))
    pos, nm = tpwm.pwm_match_compact(torch.from_numpy(scores),
                                     torch.from_numpy(ends), n_true,
                                     threshold, window, cap)
    jscores = jpwm.pwm_scores_packed(jnp.asarray(words),
                                     jnp.asarray(matrix), window)
    jpos, jnm = jpwm.pwm_match_compact(
        jscores[: len(scores)], jnp.asarray(ends), n_true,
        jnp.float32(threshold), window, cap)
    nm, jnm = int(nm), int(jnm)
    assert nm == jnm
    assert nm > cap if cap < 1000 else 0 < nm <= cap
    m = min(nm, cap)
    np.testing.assert_array_equal(pos.numpy()[:m], np.asarray(jpos)[:m])
    assert pos.dtype == torch.int64 and len(pos) == min(cap, len(scores))


def _counts(seed, window=11):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 31, (4, window))
    counts[1, 3] = counts[3, 0] = 0
    return {letter: [int(c) for c in row]
            for letter, row in zip("ACGT", counts)}


def test_pwm_constructors_equal_jax():
    counts = _counts(3)
    for make in ("from_dict", "from_counts"):
        got = getattr(PWM, make)(counts)
        want = getattr(JaxPWM, make)(counts)
        np.testing.assert_array_equal(got.matrix, want.matrix)
        assert got.alphabet == want.alphabet == "ACGT"
        assert got.window_size == want.window_size == 11
        assert str(got) == str(want)
    assert np.isneginf(PWM.from_dict(counts).matrix).sum() >= 2


def test_pwm_scores_equal_jax():
    pwm, jax_pwm = PWM.from_dict(_counts(5)), JaxPWM.from_dict(_counts(5))
    rng = np.random.default_rng(5)
    seq = "".join(rng.choice(list("ACGTacgt"), 500))
    got = pwm.calculate_scores(seq)
    np.testing.assert_array_equal(got, jax_pwm.calculate_scores(seq))
    assert np.isneginf(got).any()
    codes = pwm._encoding.encode(seq).raw()
    np.testing.assert_array_equal(pwm.calculate_scores(codes), got)
    window = seq[100:111]
    assert pwm.calculate_score(window) == jax_pwm.calculate_score(window)
    with pytest.raises(ValueError):
        pwm.calculate_scores("ACGN")
    with pytest.raises(TypeError):  # as in JAX: a list of ints is no str
        pwm.calculate_scores([0, 1, 2])


def test_read_jaspar_matrix_equals_jax(tmp_path):
    counts = _counts(9, window=8)
    path = tmp_path / "motif.jaspar"
    path.write_text(">MA0000.1 TEST\n" + "".join(
        f"{letter}  [ {' '.join(f'{c:5d}' for c in row)} ]\n"
        for letter, row in counts.items()))
    got, want = read_jaspar_matrix(str(path)), jax_read_jaspar(str(path))
    np.testing.assert_array_equal(got.matrix, want.matrix)
    np.testing.assert_array_equal(got.matrix, PWM.from_dict(counts).matrix)
    assert np.isneginf(got.matrix).sum() >= 2


@pytest.mark.parametrize("bad", [
    dict(window=0), dict(window=33), dict(matrix_shape=(4, 10)),
    dict(dtype=torch.float64), dict(words_dtype=torch.int64)])
def test_wrapper_rejects_bad_arguments(bad):
    _, _, words, _, _ = _batch(1, n_rows=20)
    window = bad.get("window", 11)
    w = torch.from_numpy(words.view(np.int32)).to(
        bad.get("words_dtype", torch.int32))
    m = torch.zeros(bad.get("matrix_shape", (4, max(min(window, 32), 1))),
                    dtype=bad.get("dtype", torch.float32))
    with pytest.raises(ValueError):
        pk.pwm_scores(w, m, window)
