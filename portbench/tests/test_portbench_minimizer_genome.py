"""The minimizer index cell (minimizer15-hg38-index) on the CPU: its plain
reference (portbench/minimizer_genome_reference.py) against
reference.minimizer_table, the cell at a small genome through the
harness, its two readers, and three controls that must read not
correct: the fold drops its last pass table, a window one base
shorter, and the first resident block's counts doubled.  The resident
blocks and the passes are forced small, so the small genome is folded
as hg38 is."""
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts the repo root on sys.path)
from portbench import minimizer_genome_reference as G
from portbench import reference as R
from portbench.harness import run_cell
from portbench.registry import HERE, Registry

CELL = "minimizer15-hg38-index"
CONFIG = "minimizer15-hg38-minimap2"


def _rows(seed, n_rows=20, hi=3000):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, hi, n_rows)
    lengths[[1, 4]] = [0, 23]
    return rng.integers(0, 4, int(lengths.sum())).astype(np.uint8), lengths


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("k,w", [(15, 24), (5, 12), (4, 4), (9, 9)])
def test_reference_equals_minimizer_table(monkeypatch, k, w, parts):
    # the keys in `parts` parts, and in parts of 2^24 keys at most (k = 15
    # takes 64: 4^15 int64 counts would not fit a test's memory)
    monkeypatch.setattr(G, "PART_KEYS", min(4 ** k // parts, 1 << 24))
    monkeypatch.setattr(R, "BLOCK_BASES", 5000)  # several blocks of rows
    flat, lengths = _rows(k + w)
    keys, counts = G.minimizer_table(flat, lengths, k, w, "cpu")
    want_keys, want_counts = R.minimizer_table(flat, lengths, k, w, "cpu")
    assert torch.equal(keys, want_keys) and torch.equal(counts, want_counts)
    assert keys.dtype == counts.dtype == torch.int64
    assert int(counts.sum()) == int(np.maximum(lengths - w + 1, 0).sum())


@pytest.fixture
def small(monkeypatch, tmp_path):
    """The committed cell over 25 rows of 1-8,300 bases, held as resident
    blocks of at most 40,000 bases and folded from passes of at most
    12,000, at most 36,000 rows a fold (the cell's ratio of a fold to a
    pass); the reference counts 2^22 keys at a time."""
    from bionumpy_tpu_torch.ops import kmers
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 40_000)
    monkeypatch.setattr(kmers, "TABLE_PASS_POSITIONS", 12_000)
    monkeypatch.setattr(kmers, "FOLD_ROWS", 36_000)
    monkeypatch.setattr(G, "PART_KEYS", 1 << 22)
    os.makedirs(tmp_path / "configs")
    with open(os.path.join(HERE, "configs", CONFIG + ".json")) as f:
        config = json.load(f)
    config["genome"]["chromosome_sizes"] = {
        name: max(n // 30_000, 1)
        for name, n in config["genome"]["chromosome_sizes"].items()}
    (tmp_path / "configs" / (CONFIG + ".json")).write_text(json.dumps(config))
    return Registry([str(tmp_path), HERE])


def _run(reg, trace=False):
    return run_cell(reg, CELL, 2 ** 31 + 77, 0.3, trace, "cpu",
                    time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_a_small_genome(small, trace):
    res = _run(small, trace)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert all(c["value"] == 0 == c["limit"]
               for c in res["checks"].values())
    if trace:
        # the accumulator at its rows and each pass's table, padding in
        assert res["metrics"]["fold_rows_per_base"]["value"] > 1.0
        # every sort: the passes' tables and the folds
        assert res["metrics"]["sorted_keys_per_base"]["value"] > \
            res["metrics"]["fold_rows_per_base"]["value"]
        # the profiler's kernel time exists on the card only
        assert "kmer_keys_roofline" not in res["metrics"]
        # CUDA event pairs time the folds on the card only
        assert "fold_device_ms_per_gbase" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"setup_s", "job_mbases_per_s"}


def _drop_last_pass(monkeypatch):
    from bionumpy_tpu_torch.ops import kmers
    fold = kmers.fold_tables
    monkeypatch.setattr(kmers, "fold_tables",
                        lambda passes, *a: fold(passes[:-1], *a))


def _window_shorter(monkeypatch):
    from bionumpy_tpu_torch.ops import minimizers
    keys = minimizers.minimizer_keys_masked
    monkeypatch.setattr(
        minimizers, "minimizer_keys_masked",
        lambda words, ends, n, k, n_kmers: keys(words, ends, n, k,
                                                n_kmers - 1))


def _block_counts_doubled(monkeypatch):
    """The counts of every pass table of the first resident block doubled
    (the tables keep their shapes, so the cell's memory does not grow)."""
    from bionumpy_tpu_torch.ops import kmers
    fold, table = kmers.fold_tables, kmers.sentinel_table
    first_block = []

    def marked(make_keys, double):
        def make():
            first_block[:] = [double]
            return make_keys()
        return make

    def doubled(keys, cap):
        t_keys, cnt, meta = table(keys, cap)
        return t_keys, cnt * 2 if first_block[0] else cnt, meta

    def folded(passes, *a):
        # each pass is (rows, functools.partial(_pass_keys, pass, keys_of))
        first = passes[0][1].args[0][0]
        return fold([(rows, marked(p, p.args[0][0] is first))
                     for rows, p in passes], *a)
    monkeypatch.setattr(kmers, "fold_tables", folded)
    monkeypatch.setattr(kmers, "sentinel_table", doubled)


@pytest.mark.parametrize("plant", [_drop_last_pass, _window_shorter,
                                   _block_counts_doubled])
def test_control_is_not_correct(small, monkeypatch, plant):
    plant(monkeypatch)
    res = _run(small)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["rows_differing"]["value"] > 0


def test_fold_readers():
    reg = Registry([HERE])
    rows = reg.metric("fold_rows_per_base").read
    ms = reg.metric("fold_device_ms_per_gbase").read
    ctx = SimpleNamespace(gbases=2.0, stages={"table-fold": {
        "rows": 9 * 10 ** 9, "device_seconds": 1.5}})
    assert rows(ctx) == pytest.approx(4.5)
    assert ms(ctx) == pytest.approx(750.0)
    for stages in ({}, {"table-fold": {"rows": 0}}):
        ctx = SimpleNamespace(gbases=2.0, stages=stages)
        assert rows(ctx) is None and ms(ctx) is None
