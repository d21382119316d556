"""The k-mer spectrum cell (kmer21-spectrum-dm6) on the CPU: its
configuration's size, the cell at a small genome through the harness,
its reader, and four controls that must read not correct: the forward
key in place of the canonical one, one pass's table dropped, the last
window of every read lost, and the reference's own table under 32-bit
fingerprint keys (the configuration states full 42-bit keys; the
benchmark's own control, portbench/control.py, fingerprints the
spectrum's bins, which are small numbers, and so is blind here).  The
resident blocks and the passes are forced small, so the small read set
is folded as the cell's 4.13 G bases are."""
import json
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts the repo root on sys.path)
from portbench import kmer_spectrum_reference as S
from portbench import reference as R
from portbench import traffic
from portbench.harness import Context, run_cell
from portbench.registry import HERE, Registry

CELL = "kmer21-spectrum-dm6"
CONFIG = "kmer21-dm6-genomescope"


def _config():
    with open(os.path.join(HERE, "configs", CONFIG + ".json")) as f:
        return json.load(f)


def test_configuration_is_a_30x_run_of_dm6():
    c = _config()
    sizes = c["genome"]["chromosome_sizes"]
    assert len(sizes) == 8 and sum(sizes.values()) == 137_567_484
    r = c["reads"]
    assert r["n_arrays"] == 1 and r["reads_per_array"] == r["n_reads"]
    assert r["n_reads"] * r["read_length"] == 4_127_024_550
    assert round(r["n_reads"] * r["read_length"] / sum(sizes.values()),
                 3) == 30.0
    assert abs(traffic.phred_error_rate(r["quality_weights"])
               - 0.000921) < 1e-6
    assert c["kmers"] == {"k": 21, "canonical": True, "max_count": 10000,
                          "cap": 1 << 28}
    assert c["reduced"] == ["genome_bases"]
    bench = Registry([HERE]).benchmark
    assert any(w["name"] == CELL and w["chips"] == 1
               for w in bench["workloads"])


def _small_registry(tmp_path, divisor, n_reads, cap):
    os.makedirs(tmp_path / "configs", exist_ok=True)
    config = _config()
    config["genome"]["chromosome_sizes"] = {
        name: max(n // divisor, 1)
        for name, n in config["genome"]["chromosome_sizes"].items()}
    config["reads"]["n_reads"] = config["reads"]["reads_per_array"] = n_reads
    config["kmers"]["cap"] = cap
    (tmp_path / "configs" / (CONFIG + ".json")).write_text(json.dumps(config))
    return Registry([str(tmp_path), HERE])


@pytest.fixture
def small(monkeypatch, tmp_path):
    """The committed cell over dm6's lengths / 1000 at 30x (27,513 reads,
    4.13 M bases), held as resident blocks of at most 1.5 M bases and
    tabled in passes of at most 300,000, at most 900,000 rows a fold."""
    from bionumpy_tpu_torch.ops import kmers
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 1_500_000)
    monkeypatch.setattr(kmers, "TABLE_PASS_POSITIONS", 300_000)
    monkeypatch.setattr(kmers, "FOLD_ROWS", 900_000)
    return _small_registry(tmp_path, 1000, 27_513, 1 << 18)


def _run(reg, trace=False):
    return run_cell(reg, CELL, 2 ** 31 + 91, 0.3, trace, "cpu",
                    time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_a_small_genome(small, trace):
    from bionumpy_tpu_torch import instrument
    res = _run(small, trace)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert all(c["value"] == 0 == c["limit"]
               for c in res["checks"].values())
    rep = instrument.report()
    # passes and folds ran, only the spectrum was fetched
    assert rep["table-passes"]["rows"] > 8 * rep["table-passes"]["calls"]
    assert rep["D2H"]["bytes"] == 8 * 10001 * rep["D2H"]["calls"]
    assert "cap-rerun" not in rep
    if trace:
        assert res["metrics"]["sorted_keys_per_base"]["value"] > 0.9
        assert res["metrics"]["fold_rows_per_base"]["value"] > 1.0
        # the profiler's kernel time and the event pairs exist on the card
        assert "kmer_keys_roofline" not in res["metrics"]
        assert "spectrum_device_ms_per_gbase" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"setup_s", "job_mbases_per_s"}


def _forward_keys(monkeypatch):
    from bionumpy_tpu_torch.ops import kmers
    keys_of = kmers.kmer_keys_of
    monkeypatch.setattr(kmers, "kmer_keys_of",
                        lambda k, canonical=False: keys_of(k, False))


def _drop_last_pass(monkeypatch):
    from bionumpy_tpu_torch.ops import kmers
    fold = kmers.fold_tables
    monkeypatch.setattr(kmers, "fold_tables",
                        lambda passes, *a: fold(passes[:-1], *a))


def _last_window_lost(monkeypatch):
    """Each row's last window keyed as the sentinel, as a row-end test one
    base off would key it."""
    from bionumpy_tpu_torch.ops import kmer_kernels, kmers
    plain = kmer_kernels.kmer_keys

    def lost(words, ends, k, n_true=None, canonical=False):
        keys = plain(words, ends, k, n_true, canonical=canonical).clone()
        e = ends.to(torch.int64)
        starts = torch.cat([e.new_zeros(1), e[:-1]])
        last = (e - k)[e - starts >= k]
        keys[last] = kmer_kernels.SENTINEL
        return keys
    monkeypatch.setattr(kmers, "kmer_keys", lost)


@pytest.mark.parametrize("plant", [_forward_keys, _drop_last_pass,
                                   _last_window_lost])
def test_control_is_not_correct(small, monkeypatch, plant):
    plant(monkeypatch)
    res = _run(small)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["rows_differing"]["value"] > 0
    assert res["checks"]["digests_differing"]["value"] > 0


def test_reference_under_32_bit_keys_is_not_correct(tmp_path):
    """The reference's own table, its keys cut to their low 32 bits (a
    fingerprint table) and then reduced to a spectrum, against the
    reference: merged rows move distinct k-mers from low bins to higher
    ones.  dm6's lengths / 200 at 3x, ~0.7 M distinct keys, ~55 such
    merges expected."""
    reg = _small_registry(tmp_path, 200, 20_000, 1 << 20)
    ctx = Context(reg, CELL, "cpu")
    entry = reg.entry(ctx.cell["entry"])
    with tempfile.TemporaryDirectory() as workdir:
        inp, = traffic.make_inputs(ctx.cell, ctx.config, 17, workdir,
                                   write_files=False)
    p = ctx.config["kmers"]
    ref = entry.reference(ctx, inp, "cpu")
    keys, counts = S.kmer_table(inp.flat, inp.lengths, p["k"], True, "cpu")
    assert keys.max() >= 1 << 32 and keys.numel() > 500_000
    _, merged = R.fingerprint_control(keys, counts)
    h = S.spectrum_of(merged, p["max_count"])
    out = entry.spectrum_table(h.numpy())
    got = entry.compare(out, ref, "cpu")
    assert got["rows_differing"] > 0
    assert R.digest(out) != R.digest(ref)
    # the spectrum of the full table is the reference's, bin for bin
    full = S.spectrum_of(counts, p["max_count"])
    assert torch.equal(full[1:], ref["counts"][1:])
    assert int(ref["counts"][0]) == entry.checksum(full.numpy())


@pytest.mark.parametrize("bits", [1, 3, 6])
def test_reference_parts_do_not_change_the_table(monkeypatch, bits):
    rng = np.random.default_rng(bits)
    lengths = rng.integers(0, 400, 50)
    flat = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    flat = np.concatenate([flat, flat])
    lengths = np.concatenate([lengths, lengths])
    monkeypatch.setattr(R, "BLOCK_BASES", 3000)  # several blocks of rows
    whole = S.kmer_table(flat, lengths, 21, True, "cpu")
    monkeypatch.setattr(S, "PART_BITS", bits)
    keys, counts = S.kmer_table(flat, lengths, 21, True, "cpu")
    assert torch.equal(keys, whole[0]) and torch.equal(counts, whole[1])
    assert torch.all(keys[1:] > keys[:-1]) and int(counts.min()) >= 2
    assert int(counts.sum()) == int(np.maximum(lengths - 20, 0).sum())


def test_every_job_digest_holds_every_bin():
    """A count moved between two bins of the genomic peak, added to one
    or lost from one, changes the digest of the entry's table, whose row
    0 is the checksum of every bin; the bins alone, one in every
    DIGEST_STRIDE, would digest these the same.  The entry's table
    passes compare_output against itself."""
    entry = Registry([HERE]).entry("kmer_spectrum_reads")
    rng = np.random.default_rng(5)
    h = rng.integers(0, 10_000_000, 10_001)
    h[0] = 0
    table = entry.spectrum_table(h)
    assert list(table["keys"][:3]) == [0, 1, 2]
    assert len(table["keys"]) == 10_001
    assert np.array_equal(table["counts"][1:], h[1:])
    assert entry.compare(table, {n: torch.as_tensor(v) for n, v in
                                 table.items()}, "cpu")["rows_differing"] == 0
    seen = {R.digest(table)}
    for a, b in [(25, 26), (5, 80), (2, 1), (1, 10_000)]:
        for moved in ((a, b, 1), (a, None, 1), (None, b, 1)):
            g = h.copy()
            if moved[0] is not None:
                g[moved[0]] -= 1
            if moved[1] is not None:
                g[moved[1]] += 1
            bins = {"keys": np.arange(1, 10_001), "counts": g[1:]}
            if a % R.DIGEST_STRIDE != 1 and b % R.DIGEST_STRIDE != 1:
                assert R.digest(bins) == R.digest(
                    {"keys": np.arange(1, 10_001), "counts": h[1:]})
            seen.add(R.digest(entry.spectrum_table(g)))
    assert len(seen) == 13


def test_spectrum_reader():
    read = Registry([HERE]).metric("spectrum_device_ms_per_gbase").read
    ctx = SimpleNamespace(gbases=4.0, stages={"kmer-spectrum": {
        "rows": 10, "device_seconds": 0.02}})
    assert read(ctx) == pytest.approx(5.0)
    for stages in ({}, {"kmer-spectrum": {"rows": 10}}):
        assert read(SimpleNamespace(gbases=4.0, stages=stages)) is None
