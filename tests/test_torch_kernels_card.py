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


SPAN = 512  # positions a warp of the kernels owns (csrc/packed_span.cuh)
EDGE_LAYOUTS = ["long_rows", "empty_rows", "unit_rows"]


def _edge_batch(layout, seed):
    """Rows that stress the kernels' span walk: rows far longer than a
    span, thousands of consecutive empty rows, or long stretches of
    one-base rows; packed into a position count that is not a multiple
    of the span, the row axis padded as the pipeline pads it."""
    rng = np.random.default_rng(seed)

    def normal(n):
        return rng.integers(0, 300, n)

    ones, zeros = np.ones, np.zeros
    parts = {
        "long_rows": [normal(20), [20_000], normal(5),
                      [70_001, 3, SPAN, SPAN + 1], normal(20)],
        "empty_rows": [zeros(5_000), normal(30), zeros(6_000), normal(30),
                       zeros(300)],
        "unit_rows": [normal(10), ones(3_000), rng.integers(1, 40, 500),
                      ones(1_500), normal(10)],
    }[layout]
    lengths = np.concatenate(parts).astype(np.int64)
    codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    n_positions = kk.WORD_BASES * (len(codes) // kk.WORD_BASES + 7)
    if n_positions % SPAN == 0:
        n_positions += kk.WORD_BASES
    words = pack_codes_host(codes, n_positions)
    ends = np.cumsum(lengths).astype(np.int32)
    ends = np.concatenate([ends, np.full(1000, ends[-1], np.int32)])
    return codes, lengths, torch.from_numpy(words.view(np.int32)), \
        torch.from_numpy(ends), len(codes)


def _kmer_case(k, layout, n_rows=3000):
    """(codes, lengths, words, ends, n) of a seeded batch: the random
    layout of _batch, or one of EDGE_LAYOUTS."""
    if layout == "random":
        return _batch(k, n_rows=n_rows)
    return _edge_batch(layout, k)


def _n_trues(n):
    """The data's end, just before it, inside a span, and nothing."""
    return (n, n - 77, n // 2 + 37, 0)


# the random layout keeps its ids (the k alone)
KMER_CASES = [pytest.param(k, "random", id=str(k))
              for k in (1, 15, 16, 17, 31)] + \
    [pytest.param(k, layout, id=f"{layout}-{k}")
     for layout in EDGE_LAYOUTS for k in (1, 16, 31)]


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


@pytest.mark.parametrize("k, layout", KMER_CASES)
def test_plain_keys_match_numpy_recount(k, layout):
    codes, lengths, words, ends, n = _kmer_case(k, layout, n_rows=400)
    n_positions = (words.numel() - 2) * kk.WORD_BASES
    for n_true in _n_trues(n):
        got = kk.kmer_keys(words, ends, k, n_true).numpy()
        np.testing.assert_array_equal(
            got, _numpy_keys(codes, lengths, n_positions, k, n_true))


@pytest.mark.parametrize("k", [1, 3, 15, 16, 17, 31])
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


def _plain_sums(words, k, n_positions):
    """[lo, hi] of the plain version over positions 0..n_positions-1."""
    lo, hi = kk.window_limbs_plain(words, k)
    return [int(lo[:n_positions].sum()) & 0xFFFFFFFF,
            int(hi[:n_positions].sum()) & 0xFFFFFFFF]


def _closed_form_sums(words, k, n):
    """kmer_fullsum_kernel's arithmetic in numpy: the code sum of the
    positions below n (two popcounts per whole word, the partial word
    masked) times each limb's full weight, plus the codes in [0, k-1)
    and [max(n, k-1), n+k-1) times their own weight less the full one
    they were counted with.  uint64 throughout, reduced mod 2^32."""
    w = words.numpy().view(np.uint32).astype(np.uint64)

    def popc(x):
        return np.unpackbits(x.astype("<u4").view(np.uint8)).sum(
            dtype=np.uint64)

    def digit_sum(x):
        return popc(x) + popc(x & np.uint64(0xAAAAAAAA))

    n_whole, rest = divmod(n, 16)
    digits = digit_sum(w[:n_whole])
    if rest:
        digits += digit_sum(w[n_whole: n_whole + 1]
                            & np.uint64((1 << 2 * rest) - 1))
    edge = k - 1
    codes = np.concatenate([np.arange(0, edge),
                            np.arange(max(n, edge), n + edge)])
    c = (w[codes >> 4] >> (2 * (codes & 15)).astype(np.uint64)) & np.uint64(3)
    sums = []
    for o, e in ((0, min(k, 16)), (16, max(k - 16, 0))):
        full = ((1 << 2 * e) - 1) // 3
        first = np.maximum(o, codes - n + 1)
        last = np.minimum(o + e - 1, codes)
        weight = np.where(first <= last,
                          ((1 << 2 * (last - o + 1))
                           - (1 << 2 * (np.maximum(first, o) - o))) // 3, 0)
        weight = weight - np.where(codes < n, full, 0)
        total = int(full) * int(digits) + int((c.astype(np.int64)
                                               * weight).sum())
        sums.append(total & 0xFFFFFFFF)
    return sums


FULLSUM_COUNTS = [1, 15, 17, 63, 511, 513, 1001, 4098]


@pytest.mark.parametrize("k", range(1, kk.MAX_K + 1))
def test_closed_form_fullsum_matches_plain_version(k):
    """The closed form the kernel computes, against the plain version's
    window-by-window sums, for whole batches and counts that end inside
    a word or before the edges meet."""
    _, _, words, _, _ = _batch(60 + k, n_rows=40)
    n_positions = (words.numel() - 2) * kk.WORD_BASES
    assert _closed_form_sums(words, k, n_positions) == \
        kk.kmer_fullsum_plain(words, k).tolist()
    for n in FULLSUM_COUNTS + [2, 16, 29, 31, 33]:
        assert _closed_form_sums(words, k, n) == _plain_sums(words, k, n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k, layout", KMER_CASES)
def test_kernels_match_plain_versions_on_card(cuda, k, layout):
    _, _, words, ends, n = _kmer_case(k, layout)
    words, ends = words.to(cuda), ends.to(cuda)
    before = dict(kk.LAUNCHES)
    for n_true in _n_trues(n):
        got = kk.kmer_keys(words, ends, k, n_true)
        assert torch.equal(got, kk.kmer_keys_plain(words, ends, k, n_true))
    torch.testing.assert_close(kk.kmer_fullsum(words, k),
                               kk.kmer_fullsum_plain(words, k),
                               rtol=0, atol=0)
    assert kk.LAUNCHES["kmer_keys_kernel"] == \
        before["kmer_keys_kernel"] + len(_n_trues(n))
    assert kk.LAUNCHES["kmer_fullsum_kernel"] == \
        before["kmer_fullsum_kernel"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("k, layout", KMER_CASES)
def test_canonical_keys_match_plain_version_on_card(cuda, k, layout):
    """Kernel 1's canonical instance equals its plain version (a digit at a
    time), counted apart from the forward instance."""
    _, _, words, ends, n = _kmer_case(k, layout)
    words, ends = words.to(cuda), ends.to(cuda)
    before = dict(kk.LAUNCHES)
    for n_true in _n_trues(n):
        got = kk.kmer_keys(words, ends, k, n_true, canonical=True)
        assert torch.equal(got, kk.kmer_keys_plain(words, ends, k, n_true,
                                                   canonical=True))
        forward = kk.kmer_keys(words, ends, k, n_true)
        assert bool((got <= forward).all())
    assert kk.LAUNCHES["kmer_keys_kernel.canonical"] == \
        before["kmer_keys_kernel.canonical"] + len(_n_trues(n))
    assert kk.LAUNCHES["kmer_keys_kernel"] == \
        before["kmer_keys_kernel"] + len(_n_trues(n))


@pytest.mark.cuda
@pytest.mark.parametrize("n_positions", [1, 63, 511, 1001, 4098])
def test_kernels_write_exactly_their_positions_on_card(cuda, n_positions):
    """Through the C entry points, counts the wrappers never pass (not a
    multiple of a word, of a lane's positions or of a span): each kernel
    writes positions below n_positions, equal to its plain version, and
    nothing past them."""
    _, _, words, ends, n = _batch(5, n_rows=30)
    words, ends = words.to(cuda), ends.to(cuda)
    stream = torch.cuda.current_stream().cuda_stream
    keys = torch.full((n_positions + 64,), -1, dtype=torch.int64,
                      device=cuda)
    assert kk.build().kmer_keys_launch(
        words.data_ptr(), ends.data_ptr(), ends.numel(), n_positions, n,
        31, keys.data_ptr(), stream) == 0
    want = kk.kmer_keys_plain(words, ends, 31, n)[:n_positions]
    assert torch.equal(keys[:n_positions], want)
    assert (keys[n_positions:] == -1).all()
    matrix = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (4, 11)).astype(np.float32)).to(cuda)
    out = torch.full((n_positions + 64,), np.nan, device=cuda)
    assert pk.build().pwm_scores_launch(
        words.data_ptr(), n_positions, matrix.data_ptr(), 11,
        out.data_ptr(), stream) == 0
    want = pk.pwm_scores_plain(words, matrix, 11)[:n_positions]
    assert torch.equal(out[:n_positions], want)
    assert torch.isnan(out[n_positions:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, kk.MAX_K + 1))
def test_fullsum_kernel_matches_plain_version_for_every_k_on_card(cuda, k):
    """kmer_fullsum_kernel, through its wrapper (one launch a call),
    equals the plain version exactly."""
    _, _, words, _, _ = _batch(80 + k)
    words = words.to(cuda)
    before = kk.LAUNCHES["kmer_fullsum_kernel"]
    torch.testing.assert_close(kk.kmer_fullsum(words, k),
                               kk.kmer_fullsum_plain(words, k),
                               rtol=0, atol=0)
    assert kk.LAUNCHES["kmer_fullsum_kernel"] == before + 1


def _fullsum_launch(words, n_positions, k, offset=0):
    """[lo, hi] of one launch of the C entry point over the words from
    word `offset` on."""
    out = torch.zeros(2, dtype=torch.int32, device=words.device)
    assert kk.build().kmer_fullsum_launch(
        words.data_ptr() + 4 * offset, n_positions, k, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream) == 0
    return (out.to(torch.int64) & 0xFFFFFFFF).tolist()


def _past_two_waves(device):
    """A position count past two waves of kmer_fullsum_kernel's
    persistent grid, so that its main loop runs more than once a lane:
    a wave is at most 8 resident blocks of 256 lanes on each SM, and a
    block's share 32,768 positions (two 16-byte loads a lane)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 2 * sms * 8 * 32_768 + (1 << 21) + 3 * kk.WORD_BASES + 5


@pytest.mark.cuda
@pytest.mark.parametrize("n_positions", FULLSUM_COUNTS + ["past_two_waves"])
def test_fullsum_kernel_sums_exactly_its_positions_on_card(cuda,
                                                           n_positions):
    """Through the C entry point, counts the wrappers never pass (inside
    a word, short of the edges, past two waves of the grid) and words
    that start 0-3 words past a 16-byte boundary: the kernel gives the
    plain version's sums over the first n_positions positions, and two
    launches give the same sums."""
    if n_positions == "past_two_waves":
        n_positions = _past_two_waves(cuda)
    rng = np.random.default_rng(n_positions)
    n_words = n_positions // kk.WORD_BASES + 8
    words = torch.from_numpy(rng.integers(
        0, 2 ** 32, n_words, dtype=np.uint64).astype(np.uint32)
        .view(np.int32)).to(cuda)
    for k in (1, 15, 16, 17, 31):
        for offset in range(4):
            want = _plain_sums(words[offset:], k, n_positions)
            assert _fullsum_launch(words, n_positions, k, offset) == want, \
                (k, offset)
    again = [_fullsum_launch(words, n_positions, 31) for _ in range(2)]
    assert again[0] == again[1] == _plain_sums(words, 31, n_positions)


@pytest.mark.cuda
def test_card_tensor_never_takes_the_plain_version(cuda):
    """A CUDA tensor launches the kernel or raises: a wrong-typed input
    raises instead of being computed some other way."""
    _, _, words, ends, n = _batch(3)
    with pytest.raises(ValueError):
        kk.kmer_keys(words.to(cuda).to(torch.int64), ends.to(cuda), 31, n)
    with pytest.raises(ValueError):
        kk.kmer_keys(words.to(cuda), ends, 31, n)  # ends on the host


PWM_WIDTHS = list(range(1, pk.MAX_WINDOW + 1))  # each its own kernel


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


MATCH_WIDTHS = [1, 4, 11, 19, 31, 32]
MATCH_LAYOUTS = ["short_rows", "row_ends", "long_rows"]
MATCH_BASE = (5 << 31) + 3  # past 2^31


def _match_case(window, layout):
    """Packed rows for kernel 3's match mode, their int32 ends, the base
    count, a float32 (4, w) matrix with -inf cells and two thresholds:
    scores found in the batch, above 99% and 20% of them (below the
    top score at w = 1, whose scores take four values).  Layouts: rows
    shorter than the window and empty rows; a row end at every residue
    mod 512 (so mod 16 and mod 4); rows far longer than a span."""
    rng = np.random.default_rng(100 * window + MATCH_LAYOUTS.index(layout))
    if layout == "short_rows":
        lengths = rng.integers(0, window + 3, 20_000)
        lengths[::7] = 0
    elif layout == "row_ends":
        i = np.arange(1, 1025)
        lengths = np.diff(700 * i + (7 * i) % 512, prepend=0)
    else:
        lengths = rng.integers(0, 40_000, 30)
    codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    words, ends, n = prepare_packed(codes, lengths)
    matrix = rng.normal(0, 1, (4, window)).astype(np.float32)
    matrix[rng.integers(0, 4, 2), rng.integers(0, window, 2)] = -np.inf
    words = torch.from_numpy(words.view(np.int32))
    matrix = torch.from_numpy(matrix)
    scores = pk.pwm_scores_plain(words, matrix, window)[:n].numpy()
    finite = scores[np.isfinite(scores)]
    below_top = np.unique(finite)[-2]  # so that some score lies above
    thresholds = [float(min(np.quantile(finite, q, method="lower"),
                            below_top)) for q in (0.99, 0.2)]
    return words, torch.from_numpy(ends), n, matrix, thresholds


def _match_n_trues(n):
    """The whole batch, a count not a multiple of 4 or 16, and one that
    ends inside a row."""
    return [n, n - 5 if (n - 5) % 4 else n - 6, n // 3 + 1]


@pytest.mark.parametrize("layout", MATCH_LAYOUTS)
@pytest.mark.parametrize("window", MATCH_WIDTHS)
def test_plain_pwm_matches_equal_the_compaction(window, layout):
    """pwm_matches on the CPU (its plain version) gives the positions
    and the count of pwm_match_compact over pwm_scores_plain's scores,
    plus the base, at a cap above and below the count."""
    from bionumpy_tpu_torch.ops import pwm as ops_pwm
    words, ends, n, matrix, thresholds = _match_case(window, layout)
    scores = pk.pwm_scores_plain(words, matrix, window)
    for n_true in _match_n_trues(n):
        for t in thresholds:
            for cap in (7, 1 << 30):
                want, want_n = ops_pwm.pwm_match_compact(
                    scores, ends, n_true, t, window, cap)
                got, got_n = pk.pwm_matches(words, ends, n_true, matrix,
                                            window, t, cap, MATCH_BASE)
                assert int(got_n) == int(want_n) > 0
                k = min(cap, int(want_n))
                assert got.numel() == want.numel()
                assert torch.equal(got[:k], want[:k] + MATCH_BASE)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MATCH_LAYOUTS)
@pytest.mark.parametrize("window", MATCH_WIDTHS)
def test_pwm_matches_kernel_matches_plain_version_on_card(cuda, window,
                                                          layout):
    """Kernel 3's match mode against its plain version: the same count
    and, once sorted, the same positions, for each n_true and
    threshold; one launch each."""
    words, ends, n, matrix, thresholds = _match_case(window, layout)
    on_card = words.to(cuda), ends.to(cuda), matrix.to(cuda)
    before = pk.LAUNCHES["pwm_scores_kernel.match"]
    launches = 0
    for n_true in _match_n_trues(n):
        for t in thresholds:
            want, want_n = pk.pwm_matches_plain(words, ends, n_true, matrix,
                                                window, t, 1 << 30,
                                                MATCH_BASE)
            got, got_n = pk.pwm_matches(on_card[0], on_card[1], n_true,
                                        on_card[2], window, t, 1 << 30,
                                        MATCH_BASE)
            launches += 1
            k = int(want_n)
            assert int(got_n) == k > 0
            assert torch.equal(torch.sort(got[:k]).values.cpu(), want[:k])
    assert pk.LAUNCHES["pwm_scores_kernel.match"] == before + launches


@pytest.mark.cuda
@pytest.mark.parametrize("window", [4, 19])
def test_pwm_matches_kernel_counts_past_its_cap_on_card(cuda, window):
    """With a threshold below most scores and a cap of a third of the
    matches: the count is exact, the cap slots hold distinct matches,
    and one more launch at the exact count holds them all."""
    words, ends, n, matrix, thresholds = _match_case(window, "row_ends")
    want, want_n = pk.pwm_matches_plain(words, ends, n, matrix, window,
                                        thresholds[1], 1 << 30)
    k = int(want_n)
    cap = k // 3
    args = words.to(cuda), ends.to(cuda), n, matrix.to(cuda), window, \
        thresholds[1]
    got, got_n = pk.pwm_matches(*args, cap)
    assert int(got_n) == k and got.numel() == cap > 0
    held = got.cpu()
    assert torch.unique(held).numel() == cap
    assert torch.isin(held, want[:k]).all()
    got, got_n = pk.pwm_matches(*args, k)
    assert int(got_n) == k
    assert torch.equal(torch.sort(got).values.cpu(), want[:k])


def _reads(seed, n_reads=300, max_len=250):
    """Seeded reads of 0..max_len bases as strings."""
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), n))
            for n in rng.integers(0, max_len, n_reads)]


def _fastq_bytes(reads):
    return "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                   for i, s in enumerate(reads)).encode()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 12, 13, 21, 31])
def test_user_kmer_api_on_card_matches_cpu(cuda, k):
    """get_kmers and count_kmers (dense k <= 12, sparse above) on the
    card equal their device="cpu" results; the card run launches the
    kmer_keys kernel once a call and uploads the array once."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import resident
    seqs = bt.as_encoded_array(_reads(k), bt.DNAEncoding)
    want_counts = bt.count_kmers(seqs, k, device="cpu")
    want_kmers = bt.get_kmers(seqs, k, device="cpu")
    resident.reset_transfer_counters()
    before = kk.LAUNCHES["kmer_keys_kernel"]
    got_counts = bt.count_kmers(seqs, k, device=cuda)
    got_kmers = bt.get_kmers(seqs, k, device=cuda)
    assert kk.LAUNCHES["kmer_keys_kernel"] == before + 2
    assert resident.TRANSFER_COUNT == 1
    assert got_counts == want_counts
    np.testing.assert_array_equal(got_kmers.lengths, want_kmers.lengths)
    np.testing.assert_array_equal(got_kmers.ravel().raw(),
                                  want_kmers.ravel().raw())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ok", "non_acgt", "short_lines",
                                  "no_plus"])
def test_device_parse_ops_on_card_match_cpu(cuda, case):
    """fastq_scan, fastq_to_kmer_counts and fastq_to_sparse_kmer_table on
    the card equal their CPU results, well-formed or not."""
    from bionumpy_tpu_torch.encodings import DNAEncoding
    from bionumpy_tpu_torch.ops import parse
    raw = _fastq_bytes(_reads(7, n_reads=200))
    if case == "non_acgt":
        raw = raw.replace(b"\nA", b"\nN", 1)
    elif case == "short_lines":
        raw += b"@\nA\n+\nI\n" * 4096
    elif case == "no_plus":
        raw = raw.replace(b"\n+\n", b"\n-\n", 1)
    padded = np.zeros(1 << 17, np.uint8)
    padded[: len(raw)] = np.frombuffer(raw, np.uint8)
    max_lines = len(padded) // 16
    lut = torch.from_numpy(DNAEncoding.lookup_table)
    cpu = (torch.from_numpy(padded), lut)
    card = tuple(t.to(cuda) for t in cpu)
    for fn, args in ((parse.fastq_scan, (len(raw), max_lines)),
                     (parse.fastq_to_kmer_counts,
                      (len(raw), max_lines, 6, 4 ** 6)),
                     (parse.fastq_to_sparse_kmer_table,
                      (len(raw), max_lines, 31, 1 << 12))):
        lead_cpu, lead_card = (cpu[:1], card[:1]) \
            if fn is parse.fastq_scan else (cpu, card)
        got, want = fn(*lead_card, *args), fn(*lead_cpu, *args)
        flat_got = [t for part in got for t in
                    (part if isinstance(part, tuple) else (part,))]
        flat_want = [t for part in want for t in
                     (part if isinstance(part, tuple) else (part,))]
        for g, w in zip(flat_got, flat_want):
            assert torch.equal(g.cpu(), w), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [True, "auto", False])
def test_count_kmers_fastq_on_card_matches_cpu(cuda, tmp_path, mode):
    """The whole job on the card in each transport equals the CPU run;
    the device transport launches kmer_keys once a batch."""
    import gzip

    from bionumpy_tpu_torch import pipeline
    path = tmp_path / "reads.fq.gz"
    path.write_bytes(b"".join(gzip.compress(_fastq_bytes(_reads(s)),
                                            mtime=0) for s in range(6)))
    kw = dict(k=31, cap=1 << 16, acc_cap=1 << 19, target_bases=20000,
              device_parse=mode)
    want = pipeline.count_kmers_fastq(str(path), device="cpu", **kw)
    before = kk.LAUNCHES["kmer_keys_kernel"]
    got = pipeline.count_kmers_fastq(str(path), device=cuda, **kw)
    assert kk.LAUNCHES["kmer_keys_kernel"] > before
    assert got[0] == want[0] and got[1] == want[1]


@pytest.mark.cuda
@pytest.mark.parametrize("k, w", [(21, 30), (5, 12), (4, 4)])
def test_minimizers_on_card_match_cpu(cuda, k, w):
    """get_minimizers and count_minimizers_with_gc (whole and in 3
    chunks) on the card equal their device="cpu" results; kernel 1
    launches on every card call."""
    import bionumpy_tpu_torch as bt
    seqs = bt.as_encoded_array(_reads(k + w, n_reads=600), bt.DNAEncoding)
    before = kk.LAUNCHES["kmer_keys_kernel"]
    got = bt.get_minimizers(seqs, k, w, device=cuda)
    want = bt.get_minimizers(seqs, k, w, device="cpu")
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.ravel().raw(), want.ravel().raw())
    for n_chunks in (1, 3):
        kw = dict(cap=1 << 16, bin_size=97, n_chunks=n_chunks)
        got_t, got_gc = bt.count_minimizers_with_gc(seqs, k, w, device=cuda,
                                                    **kw)
        want_t, want_gc = bt.count_minimizers_with_gc(seqs, k, w,
                                                      device="cpu", **kw)
        assert got_t == want_t
        np.testing.assert_array_equal(got_gc, want_gc)
        assert got_gc.dtype == np.int32
    assert kk.LAUNCHES["kmer_keys_kernel"] >= before + 1 + 1 + 3


@pytest.mark.cuda
def test_count_minimizers_fastq_on_card_matches_cpu(cuda, tmp_path):
    import gzip

    from bionumpy_tpu_torch import pipeline
    path = tmp_path / "reads.fq.gz"
    path.write_bytes(b"".join(gzip.compress(_fastq_bytes(_reads(s)),
                                            mtime=0) for s in range(6)))
    kw = dict(k=21, window_size=30, cap=1 << 16, acc_cap=1 << 19,
              target_bases=20000)
    want = pipeline.count_minimizers_fastq(str(path), device="cpu", **kw)
    before = kk.LAUNCHES["kmer_keys_kernel"]
    got = pipeline.count_minimizers_fastq(str(path), device=cuda, **kw)
    assert kk.LAUNCHES["kmer_keys_kernel"] > before
    assert got[0] == want[0] and got[1] == want[1]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 11, 32, 40])
def test_motif_scans_on_card_match_cpu(cuda, w):
    """get_motif_scores (over 2^15 bases, so on the device) and
    get_motif_matches on the card equal their device="cpu" results, bit
    for bit; windows up to 32 launch the pwm_scores kernel, in scores
    mode for the scores and in match mode for the matches."""
    import bionumpy_tpu_torch as bt
    rng = np.random.default_rng(w)
    counts = rng.integers(0, 31, (4, w))
    counts[0, 0] = 0  # a -inf cell
    pwm = bt.PWM.from_dict(dict(zip("ACGT", counts.tolist())))
    seqs = bt.as_encoded_array(_reads(w, n_reads=400), bt.DNAEncoding)
    assert seqs.size > 1 << 15
    before = pk.LAUNCHES["pwm_scores_kernel"]
    got = bt.get_motif_scores(seqs, pwm, device=cuda)
    want = bt.get_motif_scores(seqs, pwm, device="cpu")
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(np.asarray(got.ravel()),
                                  np.asarray(want.ravel()))
    flat = np.asarray(want.ravel())
    threshold = float(np.percentile(flat[np.isfinite(flat)], 99))
    match_before = pk.LAUNCHES["pwm_scores_kernel.match"]
    got = bt.get_motif_matches(seqs, pwm, threshold, cap=64, device=cuda)
    want = bt.get_motif_matches(seqs, pwm, threshold, cap=64, device="cpu")
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.ravel(), want.ravel())
    # windows up to 32: one scores-mode launch for the scores, one
    # match-mode launch for the matches and one more past the cap
    fused = w <= 32
    assert pk.LAUNCHES["pwm_scores_kernel"] == before + fused
    assert pk.LAUNCHES["pwm_scores_kernel.match"] == match_before + (
        fused * (1 + (int(want.lengths.sum()) > 64)))


def _to(dev, *tensors):
    return [t.to(dev) for t in tensors]


def _ints(values):
    return [int(v) for v in values]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 12, 16, 17, 31])
@pytest.mark.parametrize("cut", [0, 1, 333])
def test_kmer_checksums_on_card_match_cpu(cuda, k, cut):
    """The three checksums on the card equal their CPU results (an odd
    n_true too); kmer_checksum_packed launches the fullsum kernel once,
    the two pipeline checksums the keys kernel once each."""
    from bionumpy_tpu_torch.ops import kmers as tk
    codes, lengths, words, ends, n = _batch(k)
    n_true = n - cut
    padded, _, _ = tk.prepare_codes(codes, lengths)
    padded = torch.from_numpy(padded)
    lengths32 = torch.from_numpy(lengths.astype(np.int32))
    want = [_ints(tk.kmer_checksum_packed(words, ends, k)),
            _ints(tk.kmer_checksum_pipeline_packed(words, ends, k, n_true)),
            _ints(tk.kmer_checksum_pipeline(padded, lengths32, k, n_true))]
    words_d, ends_d, padded_d, lengths_d = _to(cuda, words, ends, padded,
                                               lengths32)
    kk.reset_launches()
    got = [_ints(tk.kmer_checksum_packed(words_d, ends_d, k))]
    assert kk.LAUNCHES == {"kmer_keys_kernel": 0, "kmer_fullsum_kernel": 1,
                           "kmer_keys_kernel.canonical": 0}
    got.append(_ints(tk.kmer_checksum_pipeline_packed(words_d, ends_d, k,
                                                      n_true)))
    got.append(_ints(tk.kmer_checksum_pipeline(padded_d, lengths_d, k,
                                               n_true)))
    assert kk.LAUNCHES == {"kmer_keys_kernel": 2, "kmer_fullsum_kernel": 1,
                           "kmer_keys_kernel.canonical": 0}
    assert got == want
    if cut == 0:
        assert want[0] == want[1] == want[2]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 12, 31])
def test_kmer_limb_ops_on_card_match_cpu(cuda, k):
    """kmer_hashes_masked, kmer_count_small, unique_kmer_stats and
    hash_checksum (torch ops, no kernel) on the card equal the CPU."""
    from bionumpy_tpu_torch.ops import kmers as tk
    codes, lengths, *_ = _batch(100 + k)
    padded, dist, _ = tk.prepare_codes(codes, lengths)
    padded, dist = torch.from_numpy(padded), torch.from_numpy(dist)
    lo, hi, valid = tk.kmer_hashes_masked(padded, dist, k)
    dlo, dhi, dvalid = tk.kmer_hashes_masked(*_to(cuda, padded, dist), k)
    assert torch.equal(dlo.cpu(), lo) and torch.equal(dhi.cpu(), hi) and \
        torch.equal(dvalid.cpu(), valid)
    assert _ints(tk.unique_kmer_stats(dlo, dhi, dvalid)) == \
        _ints(tk.unique_kmer_stats(lo, hi, valid))
    assert _ints(tk.hash_checksum(dlo, dhi, dvalid)) == \
        _ints(tk.hash_checksum(lo, hi, valid))
    if k <= 12:
        got = tk.kmer_count_small(*_to(cuda, padded, dist), k, 4 ** k)
        assert torch.equal(got.cpu(),
                           tk.kmer_count_small(padded, dist, k, 4 ** k))


@pytest.mark.cuda
@pytest.mark.parametrize("n_true", [0, 1, 17, 12345, 99999])
def test_composition_from_packed_on_card_matches_cpu(cuda, n_true):
    """Random words, so the bits past n_true are not zero; n_true odd
    and not a multiple of 16 too."""
    from bionumpy_tpu_torch.ops import seq
    rng = np.random.default_rng(n_true)
    words = torch.from_numpy(rng.integers(0, 1 << 32, 6252, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    want = seq.composition_from_packed(words, n_true)
    assert torch.equal(seq.composition_from_packed(words.to(cuda),
                                                   n_true).cpu(), want)
    assert int(want.sum()) == n_true


@pytest.mark.cuda
def test_seq_gathers_on_card_match_cpu(cuda):
    from bionumpy_tpu_torch.ops import seq
    from bionumpy_tpu_torch.sequence.translate import DNAToProtein
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 4, 3 * 50001).astype(np.uint8))
    table = torch.from_numpy(DNAToProtein.lookup_table.copy())
    assert torch.equal(seq.translate_codons(*_to(cuda, codes, table)).cpu(),
                       seq.translate_codons(codes, table))
    lut = torch.from_numpy(np.where(np.arange(256) < 200, np.arange(256) % 4,
                                    255).astype(np.uint8))
    data = torch.from_numpy(rng.integers(0, 200, 77777).astype(np.uint8))
    data[40001] = 222
    c_cpu, first_cpu = seq.encode_with_validation(lut, data)
    c_card, first_card = seq.encode_with_validation(*_to(cuda, lut, data))
    assert torch.equal(c_card.cpu(), c_cpu) and int(first_card) == \
        int(first_cpu) == 40001
    assert torch.equal(seq.lut_gather(*_to(cuda, lut, data)).cpu(),
                       seq.lut_gather(lut, data))
    valid = data < 150
    assert torch.equal(seq.composition_counts(*_to(cuda, c_cpu, valid),
                                              4).cpu(),
                       seq.composition_counts(c_cpu, valid, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("n_reads", [20, 900])
def test_translate_dna_to_protein_on_card_matches_cpu(cuda, n_reads):
    """Below and above 2^15 codes (host route, then the card's)."""
    import bionumpy_tpu_torch as bt
    reads = [r[: len(r) // 3 * 3] for r in _reads(n_reads, n_reads)]
    seqs = bt.as_encoded_array(reads)
    got = bt.translate_dna_to_protein(seqs, device=cuda)
    want = bt.translate_dna_to_protein(seqs, device="cpu")
    assert got.tolist() == want.tolist()
    entries = bt.SequenceEntry.from_entry_tuples(
        [(f"r{i}", r) for i, r in enumerate(reads)])
    got = bt.translate_dna_to_protein(entries, device=cuda)
    assert got.sequence.tolist() == want.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("members", [1, 4])
def test_chunked_count_kmers_from_a_file_on_card_matches_cpu(cuda, tmp_path,
                                                             members):
    """The reference's streaming idiom over a small gzip FASTQ: each
    chunk of bnp.open(...).read_chunks() counted on the card, summed,
    equals device="cpu", with kernel 1 launched once a chunk."""
    import gzip

    import bionumpy_tpu_torch as bt
    reads = _reads(7, 1200)
    step = len(reads) // members
    path = tmp_path / "reads.fq.gz"
    path.write_bytes(b"".join(
        gzip.compress(_fastq_bytes(reads[i: i + step]), mtime=0)
        for i in range(0, len(reads), step)))

    def chunked(device):
        return [bt.count_kmers(bt.as_encoded_array(c.sequence,
                                                   bt.DNAEncoding), k,
                               device=device)
                for c in bt.open(str(path)).read_chunks(min_chunk_size=40_000)
                for k in (31, 5)]

    want = chunked("cpu")
    before = kk.LAUNCHES["kmer_keys_kernel"]
    got = chunked(cuda)
    assert len(want) > 4
    assert kk.LAUNCHES["kmer_keys_kernel"] - before == len(want)
    total_got = sum(got[0::2])
    total_want = sum(want[0::2])
    assert np.array_equal(total_got.label_codes, total_want.label_codes)
    assert np.array_equal(total_got.counts, total_want.counts)
    assert np.array_equal(sum(got[1::2]).counts, sum(want[1::2]).counts)


def _intervals(bt, seed, n, size, chrom="chr1"):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, size - 600, n)
    return bt.datatypes.Interval([chrom] * n, starts,
                                 starts + rng.integers(1, 600, n))


@pytest.mark.cuda
@pytest.mark.parametrize("bin_size", [None, 1, 100, 1000])
def test_get_pileup_device_on_card_matches_cpu(cuda, bin_size):
    """Dense (an RLE of int32 depths) and binned pileups on the card
    equal device="cpu", dtypes included."""
    import bionumpy_tpu_torch as bt
    iv = _intervals(bt, 3, 20_000, 1_000_003)
    got = bt.arithmetics.get_pileup_device(iv, 1_000_003, bin_size,
                                           device=cuda)
    want = bt.arithmetics.get_pileup_device(iv, 1_000_003, bin_size,
                                            device="cpu")
    if bin_size is None:
        for a, b in ((got.events, want.events), (got.values, want.values)):
            assert np.array_equal(a, b) and a.dtype == b.dtype
        assert got.values.dtype == np.int32
        assert np.array_equal(got.events,
                              bt.arithmetics.get_pileup(iv, 1_000_003).events)
    else:
        assert np.array_equal(got, want) and got.dtype == want.dtype == \
            np.int32
    default = bt.arithmetics.get_pileup_device(iv, 1_000_003, bin_size)
    assert np.array_equal(np.asarray(default.values if bin_size is None
                                     else default),
                          np.asarray(want.values if bin_size is None
                                     else want))


@pytest.mark.cuda
@pytest.mark.parametrize("bin_size", [1, 100, 1000])
def test_binned_pileup_bed_on_card_matches_cpu(cuda, tmp_path, bin_size):
    import gzip

    import bionumpy_tpu_torch as bt
    sizes = {"chr1": 400_000, "chr2": 250_001, "chr3": 1000}
    parts = [_intervals(bt, 4, 3000, sizes["chr1"], "chr1"),
             _intervals(bt, 5, 2000, sizes["chr2"], "chr2")]
    lines = "".join(f"{c}\t{s}\t{e}\n" for p in parts for c, s, e in zip(
        p.chromosome.tolist(), p.start, p.stop)) + "chrUn\t5\t9\n"
    path = tmp_path / "iv.bed.gz"
    path.write_bytes(gzip.compress(lines.encode(), mtime=0))
    got, gstats = bt.binned_pileup_bed(str(path), sizes, bin_size,
                                       device=cuda)
    want, wstats = bt.binned_pileup_bed(str(path), sizes, bin_size,
                                        device="cpu")
    assert gstats == wstats and gstats["n_intervals"] == 5000
    for name in sizes:
        assert np.array_equal(got[name], want[name])
        assert got[name].dtype == np.int32
    assert not got["chr3"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 12, 31])
def test_reverse_complement_into_count_kmers_on_card(cuda, k):
    """count_kmers of the reverse complement on the card: one upload of
    the new array, one launch of kernel 1, and the forward table with
    every hash mapped to its reverse complement."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import resident
    seqs = bt.as_encoded_array(_reads(9, 2000), bt.DNAEncoding)
    forward = bt.count_kmers(seqs, k, device="cpu")
    resident.reset_transfer_counters()
    before = kk.LAUNCHES["kmer_keys_kernel"]
    back = bt.count_kmers(bt.get_reverse_complement(seqs), k, device=cuda)
    assert resident.TRANSFER_COUNT == 1
    assert kk.LAUNCHES["kmer_keys_kernel"] - before == 1
    h = np.asarray(forward.label_codes if k > 12 else
                   np.arange(4 ** k, dtype=np.uint64), np.uint64)
    rc = np.zeros_like(h)
    for j in range(k):
        code = (h >> np.uint64(2 * j)) & np.uint64(3)
        rc |= (np.uint64(3) - code) << np.uint64(2 * (k - 1 - j))
    if k > 12:
        order = np.argsort(rc)
        assert np.array_equal(back.label_codes, rc[order])
        assert np.array_equal(back.counts, forward.counts[order])
    else:
        assert np.array_equal(back.counts[rc.astype(np.int64)],
                              forward.counts)


def _fold_parts(kind, device):
    """Per-chunk partials of seeded intervals on `device`: binned pileups
    (SUM), length bincounts (BINCOUNT) or the longest interval of each
    chunk, as a 1-element tensor (MAX)."""
    from bionumpy_tpu_torch.ops.tracks import binned_pileup
    parts = []
    for seed in range(5):
        rng = np.random.default_rng(seed)
        starts = rng.integers(0, 99_000, 700)
        stops = starts + rng.integers(1, 900, 700)
        s, e = (torch.from_numpy(a.astype(np.int32)).to(device)
                for a in (starts, stops))
        if kind == "SUM":
            parts.append(binned_pileup(
                s, e, torch.ones(len(starts), dtype=torch.bool,
                                 device=device), 1000, 100))
        elif kind == "BINCOUNT":
            parts.append(torch.bincount((e - s).long()))
        else:
            parts.append((e - s).amax().reshape(1))
    return parts


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["SUM", "BINCOUNT", "MAX"])
def test_streamed_fold_stays_on_card(cuda, kind):
    """A ReductionNode over partials made on the card folds to one tensor
    on the card, equal to the same fold with device="cpu"."""
    from bionumpy_tpu_torch import computation_graph as cg
    reduction = {"SUM": cg.SUM, "MAX": cg.MAX,
                 "BINCOUNT": cg.Reduction(cg.BINCOUNT.combine)}[kind]

    def fold(device):
        parts = _fold_parts(kind, device)
        return cg.ReductionNode(cg.StreamNode(iter(parts)),
                                reduction).compute()
    got, want = fold(cuda), fold("cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cuda"
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_streamed_operators_stay_on_card(cuda):
    """A node's operators and np.sum over chunks on the card: the map
    root is one CUDA tensor (torch.cat), the fold too, both equal to
    device="cpu"."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch import computation_graph as cg

    def run(device):
        parts = _fold_parts("BINCOUNT", device)
        expr = 2 * cg.StreamNode(iter(parts)) + 1
        parts = _fold_parts("BINCOUNT", device)
        total = np.sum(cg.StreamNode(iter(parts)) % 5)
        return bt.compute([expr, total])
    (got, got_sum), (want, want_sum) = run(cuda), run("cpu")
    assert got.device.type == got_sum.device.type == "cuda"
    assert torch.equal(got.cpu(), want) and torch.equal(got_sum.cpu(),
                                                        want_sum)


@pytest.mark.cuda
def test_kmer_lookup_on_card_matches_cpu(cuda):
    """KmerLookup on the card: one launch of kernel 1 for create_index
    and one for each string query, the lookup and the rows of each query
    equal to device="cpu"."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.sequence.indexing import KmerLookup
    reads = _reads(21, 400)
    seqs = bt.as_encoded_array(reads, bt.DNAEncoding)
    kk.reset_launches()
    card = KmerLookup.create_lookup(seqs, k=31, device=cuda)
    assert kk.LAUNCHES["kmer_keys_kernel"] == 1
    host = KmerLookup.create_lookup(seqs, k=31, device="cpu")
    assert sorted(card._kmer_index._lookup) == \
        sorted(host._kmer_index._lookup)
    queries = [r[i: i + 31] for r in reads[:40] if len(r) >= 62
               for i in (0, 30)]
    kk.reset_launches()
    for q in queries:
        got = card._kmer_index.get_indices(q)
        assert np.array_equal(got, host._kmer_index.get_indices(q))
        assert all(q in reads[i] for i in got)
    assert kk.LAUNCHES["kmer_keys_kernel"] == len(queries) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 31])
def test_debruijn_graph_on_card_matches_cpu(cuda, k):
    from bionumpy_tpu_torch.sequence.debruijn import (ColoredDeBruijnGraph,
                                                      DeBruijnGraph)
    reads = [r for r in _reads(22, 60, 120) if len(r) >= k]
    kk.reset_launches()
    card = DeBruijnGraph.from_sequences(reads, k, device=cuda)
    colored = ColoredDeBruijnGraph.from_sequences(reads, k, device=cuda)
    assert kk.LAUNCHES["kmer_keys_kernel"] == 2
    host = DeBruijnGraph.from_sequences(reads, k, device="cpu")
    assert card._kmer_set == host._kmer_set
    assert card.get_contigs() == host.get_contigs()
    assert dict(colored._color_dict) == dict(ColoredDeBruijnGraph
                                             .from_sequences(
                                                 reads, k, device="cpu")
                                             ._color_dict)


def _sbs96_recount(seqs, chroms, pos, alts):
    """bench.py's numpy SBS96 formula: the 96 counts in the order
    (ref C/T, alt rank, left base, right base), strand-collapsed."""
    code = {c: i for i, c in enumerate("ACGT")}
    counts = np.zeros(96, np.int64)
    for c, p, a in zip(chroms, pos, alts):
        left, mid, right = (code[b] for b in seqs[c][p - 1: p + 2])
        a = code[a]
        if mid in (0, 2):
            left, right, mid, a = 3 - right, 3 - left, 3 - mid, 3 - a
        counts[(((mid == 3) * 3 + a - (a > mid)) * 4 + left) * 4 + right] += 1
    labels = [f"{l}[{r}>{a}]{s}" for r in "CT" for a in "ACGT" if a != r
              for l in "ACGT" for s in "ACGT"]
    return dict(zip(labels, counts.tolist()))


@pytest.mark.cuda
def test_count_mutation_types_genomic_with_a_card(cuda):
    """Config 5's SBS96 job on a small seeded genome where a card is
    present: Genome.get_locations and the window gather of a dict-backed
    GenomicSequence give bench.py's numpy counts, label by label, and no
    kernel launches (the job is host code, as in the JAX package)."""
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.variants import count_mutation_types_genomic
    rng = np.random.default_rng(23)
    sizes = {"chr21": 20_000, "chr22": 15_000}
    seqs = {n: "".join(rng.choice(list("ACGT"), s)) for n, s in sizes.items()}
    chroms = ["chr21"] * 300 + ["chr22"] * 200
    pos = np.concatenate([np.sort(rng.integers(1, s - 1, n)) for s, n in (
        (sizes["chr21"], 300), (sizes["chr22"], 200))])
    alts = ["ACGT"[("ACGT".index(seqs[c][p]) + int(rng.integers(1, 4))) % 4]
            for c, p in zip(chroms, pos)]
    refs = [seqs[c][p] for c, p in zip(chroms, pos)]
    kk.reset_launches()
    variants = bt.datatypes.Variant(chroms, pos, refs, alts)
    locations = bt.Genome.from_dict(sizes).get_locations(variants)
    got = count_mutation_types_genomic(
        locations, bt.genomic_data.GenomicSequence.from_dict(seqs))
    assert dict(zip([str(x) for x in got.alphabet], got.counts.tolist())) \
        == _sbs96_recount(seqs, chroms, pos, alts)
    assert kk.LAUNCHES["kmer_keys_kernel"] == 0


def _mesh4(dev):
    from bionumpy_tpu_torch.parallel import create_mesh
    return create_mesh(4, devices=[dev] * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["kmers", "minimizers"])
def test_mesh_fold_step_on_card_matches_cpu(cuda, kind):
    """Three batches through a 4-shard fold step on the card and on a
    4-shard CPU mesh: equal accumulators and metas, and kernel 1
    launched once a shard a batch on the card."""
    from bionumpy_tpu_torch.parallel import sparse_parallel as sp
    from bionumpy_tpu_torch.parallel.mesh import put_sharded
    from bionumpy_tpu_torch.pipeline import _make_acc, _meta_init
    cap, acc_cap = 1 << 14, 1 << 18
    results = []
    for dev in (cuda, torch.device("cpu")):
        mesh = _mesh4(dev)
        step = sp.sharded_sparse_count_fold_step(mesh, 31, cap, acc_cap) \
            if kind == "kmers" else \
            sp.sharded_minimizer_count_fold_step(mesh, 21, 30, cap, acc_cap)
        keys, cnt, _ = _make_acc(acc_cap, dev)
        acc, meta = (keys, cnt), _meta_init(dev)
        kk.reset_launches()
        for b in range(3):
            codes, lengths, *_ = _batch(100 + b, n_rows=400)
            words, ends, n_true = sp.shard_packed_reads(codes, lengths, 4)
            acc, meta, nu = step(acc, meta,
                                 put_sharded(mesh, words.view(np.int32)),
                                 put_sharded(mesh, ends), n_true)
        nu = int(nu)
        results.append((acc[0][:nu].cpu(), acc[1][:nu].cpu(), meta.cpu(),
                        kk.LAUNCHES["kmer_keys_kernel"]))
    (gk, gc, gm, launches), (wk, wc, wm, _) = results
    assert torch.equal(gk, wk) and torch.equal(gc, wc)
    assert torch.equal(gm, wm)
    assert launches == 3 * 4


@pytest.mark.cuda
def test_mesh_pwm_match_step_on_card_matches_cpu(cuda):
    from bionumpy_tpu_torch.parallel import sparse_parallel as sp
    from bionumpy_tpu_torch.parallel.mesh import put_sharded
    codes, lengths, *_ = _batch(31, n_rows=1000)
    words, ends, n_true = sp.shard_packed_reads(codes, lengths, 4)
    rng = np.random.default_rng(32)
    matrix = torch.from_numpy(
        np.log(rng.dirichlet(np.ones(4), 11).T).astype(np.float32))
    out = []
    for dev in (cuda, torch.device("cpu")):
        mesh = _mesh4(dev)
        pk.reset_launches()
        pos, nm, total = sp.sharded_pwm_match_step(mesh, 11, 1 << 16)(
            put_sharded(mesh, words.view(np.int32)), put_sharded(mesh, ends),
            n_true, matrix, -11.0)
        # match mode writes a shard's matches in no fixed order on the card
        out.append(([torch.sort(p[: int(n)].cpu()).values
                     for p, n in zip(pos, nm)],
                    int(total), pk.LAUNCHES["pwm_scores_kernel.match"]))
    (gpos, gtotal, launches), (wpos, wtotal, _) = out
    assert gtotal == wtotal > 0
    assert all(torch.equal(a, b) for a, b in zip(gpos, wpos))
    assert launches == 4


@pytest.mark.cuda
@pytest.mark.parametrize("step_of", ["kmers", "minimizers"])
def test_mesh_halo_steps_on_card_match_one_shard(cuda, step_of):
    """A 4-shard halo step on the card equals one shard on the card and
    4 shards on the CPU, at the valid positions."""
    from bionumpy_tpu_torch.parallel import halo
    from bionumpy_tpu_torch.parallel import create_mesh
    from bionumpy_tpu_torch.parallel.mesh import put_sharded
    codes = np.random.default_rng(41).integers(0, 4, 300_007).astype(
        np.uint8)
    got = []
    for dev, n in ((cuda, 4), (cuda, 1), (torch.device("cpu"), 4)):
        mesh = create_mesh(n, devices=[dev] * n)
        step = halo.sharded_kmer_hash_step(mesh, 31) if step_of == "kmers" \
            else halo.sharded_minimizer_step(mesh, 21, 30)
        blocks, n_true = halo.shard_long_sequence(codes, n)
        lo, hi, valid = [torch.cat(p).cpu() for p in step(
            put_sharded(mesh, blocks), n_true)]
        got.append((lo | (hi << 32))[valid])
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    assert got[0].numel() > 0
