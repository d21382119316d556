"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the plain versions against a loop-free numpy recount on the
CPU.  This file imports neither JAX nor the JAX package, so it also runs
where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_card.py

The tests that need the card carry the `cuda` marker and skip without
one.  Integer keys and sums, and float32 PWM scores (accumulated in the
same order by kernel and plain version): exact equality throughout."""
import numpy as np
import pytest
import torch

from bionumpy_tpu_torch.ops import kmer_kernels as kk
from bionumpy_tpu_torch.ops import pwm_kernels as pk
from bionumpy_tpu_torch.ops.kmers import pack_codes_host, prepare_packed


def _batch(seed, n_rows=3000, max_len=300):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len, n_rows)
    lengths[::11] = rng.integers(0, 20, len(lengths[::11]))
    codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    words, ends, n = prepare_packed(codes, lengths)
    # pad the row axis as the pipeline does: repeat the last end
    ends = np.concatenate([ends, np.full(1000, ends[-1], np.int32)])
    return codes, lengths, torch.from_numpy(words.view(np.int32)), \
        torch.from_numpy(ends), n


def _numpy_keys(codes, lengths, n_positions, k, n_true):
    """Window hashes sum(code_j * 4^j) where the window fits its row and
    starts below n_true; the sentinel elsewhere."""
    keys = np.full(n_positions, kk.SENTINEL, np.int64)
    ends = np.cumsum(lengths)
    dist = np.repeat(ends, lengths) - np.arange(int(lengths.sum()))
    n = len(codes) - k + 1
    h = np.zeros(max(n, 0), np.int64)
    for j in range(k):
        h |= codes[j: j + n].astype(np.int64) << (2 * j)
    valid = (dist[:n] >= k) & (np.arange(n) < n_true)
    keys[:n][valid] = h[valid]
    return keys


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31])
def test_plain_keys_match_numpy_recount(k):
    codes, lengths, words, ends, n = _batch(k, n_rows=400)
    n_positions = (words.numel() - 2) * kk.WORD_BASES
    for n_true in (n, n - 77):
        got = kk.kmer_keys(words, ends, k, n_true).numpy()
        np.testing.assert_array_equal(
            got, _numpy_keys(codes, lengths, n_positions, k, n_true))


@pytest.mark.parametrize("k", [3, 31])
def test_plain_fullsum_matches_numpy_recount(k):
    codes, _, words, _, _ = _batch(40 + k, n_rows=400)
    n_positions = (words.numel() - 2) * kk.WORD_BASES
    padded = np.zeros(n_positions + 32, np.int64)
    padded[: len(codes)] = codes
    h = np.zeros(n_positions, np.int64)
    for j in range(k):
        h |= padded[j: j + n_positions] << (2 * j)
    want = [int((h & 0xFFFFFFFF).sum()) & 0xFFFFFFFF,
            int((h >> 32).sum()) & 0xFFFFFFFF]
    assert kk.kmer_fullsum(words, k).tolist() == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 15, 16, 17, 31])
def test_kernels_match_plain_versions_on_card(cuda, k):
    _, _, words, ends, n = _batch(k)
    words, ends = words.to(cuda), ends.to(cuda)
    before = dict(kk.LAUNCHES)
    for n_true in (n, n - 123, 0):
        got = kk.kmer_keys(words, ends, k, n_true)
        torch.testing.assert_close(
            got, kk.kmer_keys_plain(words, ends, k, n_true), rtol=0, atol=0)
    torch.testing.assert_close(kk.kmer_fullsum(words, k),
                               kk.kmer_fullsum_plain(words, k),
                               rtol=0, atol=0)
    assert kk.LAUNCHES["kmer_keys_kernel"] == \
        before["kmer_keys_kernel"] + 3
    assert kk.LAUNCHES["kmer_fullsum_kernel"] == \
        before["kmer_fullsum_kernel"] + 1


@pytest.mark.cuda
def test_card_tensor_never_takes_the_plain_version(cuda):
    """A CUDA tensor launches the kernel or raises: a wrong-typed input
    raises instead of being computed some other way."""
    _, _, words, ends, n = _batch(3)
    with pytest.raises(ValueError):
        kk.kmer_keys(words.to(cuda).to(torch.int64), ends.to(cuda), 31, n)
    with pytest.raises(ValueError):
        kk.kmer_keys(words.to(cuda), ends, 31, n)  # ends on the host


PWM_WIDTHS = [1, 4, 11, 16, 17, 31, 32]


def _pwm_inputs(seed, window, n_words=3001):
    """Seeded codes packed into n_words words (a position count that is
    not a multiple of the 16384-position bucket) and a float32 (4, w)
    matrix with -inf cells."""
    rng = np.random.default_rng(seed)
    n_positions = n_words * kk.WORD_BASES
    codes = rng.integers(0, 4, n_positions - 5).astype(np.uint8)
    words = pack_codes_host(codes, n_positions)
    matrix = rng.normal(0, 1, (4, window)).astype(np.float32)
    matrix[rng.integers(0, 4, 3), rng.integers(0, window, 3)] = -np.inf
    return codes, torch.from_numpy(words.view(np.int32)), \
        torch.from_numpy(matrix)


@pytest.mark.parametrize("window", [1, 11, 32])
def test_plain_pwm_scores_match_numpy_recount(window):
    codes, words, matrix = _pwm_inputs(window, window)
    m = matrix.numpy()
    n = len(codes)
    want = np.zeros(n, np.float32)
    for j in range(window):
        want[: n - j] += m[:, j][codes[j:]]
    got = pk.pwm_scores(words, matrix, window).numpy()
    assert len(got) == 3001 * kk.WORD_BASES
    np.testing.assert_array_equal(got[: n - window + 1],
                                  want[: n - window + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("window", PWM_WIDTHS)
def test_pwm_kernel_matches_plain_version_on_card(cuda, window):
    _, words, matrix = _pwm_inputs(window, window)
    words, matrix = words.to(cuda), matrix.to(cuda)
    before = pk.LAUNCHES["pwm_scores_kernel"]
    got = pk.pwm_scores(words, matrix, window)
    want = pk.pwm_scores_plain(words, matrix, window)
    assert torch.isneginf(want).any()
    assert torch.equal(got, want)
    assert pk.LAUNCHES["pwm_scores_kernel"] == before + 1


@pytest.mark.cuda
def test_pwm_card_tensor_never_takes_the_plain_version(cuda):
    _, words, matrix = _pwm_inputs(3, 11)
    with pytest.raises(ValueError):
        pk.pwm_scores(words.to(cuda).to(torch.int64), matrix.to(cuda), 11)
    with pytest.raises(ValueError):
        pk.pwm_scores(words.to(cuda), matrix, 11)  # matrix on the host
