"""The device table's kernels (ops/table_kernels) on the CPU.  The merge
of sorted sentinel tables: its plain version against an independent
NumPy two-pointer merge, the wrapper's checks and its CPU route, and
fold_tables through it, against the fold as it was written over
merge_hash_tables of the concatenated tables.  The run table of sorted
keys: its plain version against a NumPy run-length encoding, the
wrapper's checks and its CPU route, and sentinel_table and whole_table
through it, against the compositions they were written as and against
the JAX package.  The kernels themselves run in
tests/test_torch_table_passes_card.py."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bionumpy_tpu.ops import kmers as jkmers
from bionumpy_tpu_torch import instrument
from bionumpy_tpu_torch.ops import kmers, table_kernels as tk

S = tk.SENTINEL
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def two_pointer(tables, cap):
    """(keys, counts, n_unique) of the merge of (keys, counts) numpy
    sentinel tables, two at a time by two pointers: the first `cap`
    distinct live keys in order, each with its whole total, in
    min(cap, rows in) rows padded with (S, 0)."""
    keys, counts = np.zeros(0, np.int64), np.zeros(0, np.int64)
    for tk_, tc in tables:
        live_k, live_c = tk_[tk_ != S], tc[tk_ != S]
        out_k, out_c = [], []
        i = j = 0
        while i < len(keys) or j < len(live_k):
            if j == len(live_k) or (i < len(keys) and keys[i] < live_k[j]):
                out_k.append(keys[i])
                out_c.append(counts[i])
                i += 1
            elif i == len(keys) or live_k[j] < keys[i]:
                out_k.append(live_k[j])
                out_c.append(live_c[j])
                j += 1
            else:
                out_k.append(keys[i])
                out_c.append(counts[i] + live_c[j])
                i += 1
                j += 1
        keys = np.array(out_k, np.int64)
        counts = np.array(out_c, np.int64)
    rows = min(cap, sum(len(k) for k, _ in tables))
    n = min(len(keys), cap)
    out_k = np.full(rows, S, np.int64)
    out_c = np.zeros(rows, np.int64)
    out_k[:n], out_c[:n] = keys[:n], counts[:n]
    return out_k, out_c, n


def table(rng, rows, keys):
    """A sentinel table of `rows` rows holding the sorted unique `keys`
    (the first `rows` of them) with seeded counts of 1-99."""
    keys = np.unique(np.asarray(keys, np.int64))[:rows]
    k = np.full(rows, S, np.int64)
    c = np.zeros(rows, np.int64)
    k[:len(keys)] = keys
    c[:len(keys)] = rng.integers(1, 100, len(keys))
    return k, c


def truncated(rng, rows):
    """A pass table whose distinct keys pass its rows (n_unique past the
    rows), as sentinel_table makes it: every row live, no padding."""
    keys = torch.from_numpy(rng.integers(0, 1 << 20, 4 * rows))
    k, c, meta = kmers.sentinel_table(keys, rows)
    assert int(meta[0]) > rows and bool((k != S).all())
    return k.numpy(), c.numpy()


def _case(name, rng):
    """(tables, cap) of one named case."""
    big = (1 << 62) - 1
    if name == "disjoint":
        return [table(rng, 300, range(0, 400, 2)),
                table(rng, 250, range(1000, 1400, 3))], 1 << 20
    if name == "interleaved":
        return [table(rng, 256, range(0, 600, 2)),
                table(rng, 256, range(1, 600, 2))], 1 << 20
    if name == "identical":
        keys = rng.choice(1 << 30, 500, replace=False)
        return [table(rng, 600, keys), table(rng, 500, keys)], 1 << 20
    if name == "extremes":  # key 0 and keys near 2^62
        return [table(rng, 8, [0, 5, big - 2, big]),
                table(rng, 6, [0, 1, big - 1, big])], 1 << 20
    if name == "all-padding":
        return [table(rng, 40, []), table(rng, 30, range(7, 70, 7)),
                table(rng, 20, [])], 1 << 20
    if name == "empty":
        return [table(rng, 0, []), table(rng, 30, range(5, 50, 5))], 1 << 20
    if name == "truncated":
        return [truncated(rng, 64), truncated(rng, 48)], 1 << 20
    if name in ("cap", "cap+1"):
        a = table(rng, 100, range(0, 160, 2))  # 80 keys
        b = table(rng, 100, range(0, 100, 5))  # 20 keys, 10 new
        return [a, b], 90 - (name == "cap+1")
    n = {"two": 2, "three": 3, "four": 4}[name]
    return [table(rng, int(rng.integers(50, 400)),
                  rng.choice(1500, int(rng.integers(0, 400)), replace=False))
            for _ in range(n)], 700


CASES = ["disjoint", "interleaved", "identical", "extremes", "all-padding",
         "empty", "truncated", "cap", "cap+1", "two", "three", "four"]


def _torch(tables):
    return [(torch.from_numpy(k.copy()), torch.from_numpy(c.copy()))
            for k, c in tables]


@pytest.mark.parametrize("name", CASES)
def test_plain_merge_matches_the_two_pointer_merge(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    tables, cap = _case(name, rng)
    want_k, want_c, want_n = two_pointer(tables, cap)
    keys, counts, n_unique = tk.merge_tables_plain(_torch(tables), cap)
    distinct = len(np.unique(np.concatenate([k for k, _ in tables])[
        np.concatenate([k for k, _ in tables]) != S]))
    assert keys.dtype == counts.dtype == n_unique.dtype == torch.int64
    assert n_unique.dim() == 0 and int(n_unique) == want_n
    np.testing.assert_array_equal(keys.numpy(), want_k)
    if distinct > cap:
        # past cap the plain version cuts the last total (the kernel
        # keeps it whole); every other row is exact
        assert name == "cap+1"
        np.testing.assert_array_equal(counts.numpy()[:-1], want_c[:-1])
        assert int(counts[-1]) != want_c[-1]
    else:
        np.testing.assert_array_equal(counts.numpy(), want_c)
    if name == "cap":
        assert distinct == cap == want_n
    if name in ("cap", "cap+1"):
        assert int(n_unique) == cap


def test_the_wrapper_takes_the_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(5)
    tables, cap = _case("three", rng)
    tk.reset_launches()
    got = tk.merge_tables(_torch(tables), cap)
    want = tk.merge_tables_plain(_torch(tables), cap)
    assert tk.LAUNCHES == {"merge_tables_kernel": 0, "run_table_kernel": 0}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    one = tk.merge_tables(_torch(tables[:1]), 5)
    np.testing.assert_array_equal(one[0].numpy(), tables[0][0][:5])
    assert tk.LAUNCHES["merge_tables_kernel"] == 0


@pytest.mark.parametrize("bad", ["dtype", "device", "contiguous", "length",
                                 "none"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    k = torch.arange(8, dtype=torch.int64)
    c = torch.ones(8, dtype=torch.int64)
    tables = [(k, c), (k + 8, c.clone())]
    if bad == "dtype":
        tables[1] = (tables[1][0].to(torch.int32), c)
    elif bad == "device":
        tables[1] = (torch.empty(8, dtype=torch.int64, device="meta"),
                     torch.empty(8, dtype=torch.int64, device="meta"))
    elif bad == "contiguous":
        tables[0] = (torch.arange(16, dtype=torch.int64)[::2], c)
    elif bad == "length":
        tables[0] = (k, c[:7])
    else:
        tables = []
    with pytest.raises(ValueError):
        tk.merge_tables(tables, 16)


def _old_fold(key_passes, cap, pass_cap):
    """fold_tables as it was written before the merge: the held tables
    concatenated and merged by merge_hash_tables (sort and runs)."""
    metas, held, acc = [], [], None

    def fold():
        nonlocal acc
        if acc is not None:
            held.insert(0, acc[:2])
        keys_in = torch.cat([t[0] for t in held])
        cnt_in = torch.cat([t[1] for t in held])
        held.clear()
        acc = kmers.merge_hash_tables(keys_in, cnt_in, cap)

    for rows, make_keys in key_passes:
        held_rows = sum(t[0].numel() for t in held)
        if acc is not None:
            held_rows += acc[0].numel()
        if len(held) + (acc is not None) > 1 \
                and held_rows + rows > kmers.FOLD_ROWS:
            fold()
        t_keys, t_cnt, meta = kmers.sentinel_table(make_keys(), pass_cap)
        metas.append(meta)
        held.append((t_keys, t_cnt))
    if acc is None and len(held) == 1:
        t_keys, t_cnt = held.pop()
        acc = t_keys, t_cnt, torch.clamp(metas[0][0], max=t_keys.numel())
    elif held:
        fold()
    return acc[0], acc[1], torch.cat([*metas, acc[2].reshape(1)])


def _key_passes(seed, n_passes, size=3000, hi=5000):
    """Seeded passes of int64 keys, a fifth of them the sentinel."""
    rng = np.random.default_rng(seed)
    passes = []
    for _ in range(n_passes):
        keys = rng.integers(0, hi, size)
        keys[rng.random(size) < 0.2] = S
        passes.append((size, lambda keys=keys: torch.from_numpy(keys)))
    return passes


@pytest.mark.parametrize("fold_rows,cap,pass_cap", [
    (1, 1 << 14, 1 << 12),      # a fold at every pass
    (None, 1 << 14, 1 << 12),   # the default: one fold of every table
    (7000, 1 << 14, 1 << 12),   # folds of two tables, then the accumulator and one
    (1, 4000, 1 << 12),         # the accumulator past its cap
    (1, 1 << 14, 1000)])        # every pass table truncated
def test_fold_tables_gives_the_accumulator_and_probe_of_before(
        monkeypatch, fold_rows, cap, pass_cap):
    if fold_rows is not None:
        monkeypatch.setattr(kmers, "FOLD_ROWS", fold_rows)
    seen = []

    def spy(tables, cap):
        seen.append([t[0] for t in tables])
        return tk.merge_tables(tables, cap)

    monkeypatch.setattr(kmers, "merge_tables", spy)
    instrument.reset()
    keys, counts, probe = kmers.fold_tables(_key_passes(fold_rows or 2, 6),
                                            cap, pass_cap, False)
    rep = instrument.report()
    want = _old_fold(_key_passes(fold_rows or 2, 6), cap, pass_cap)
    for got, w in zip((keys, counts, probe), want):
        assert got.dtype == w.dtype and torch.equal(got, w)
    # the merge takes the tables as they are, the accumulator first: no
    # concatenation
    assert seen and all(len(tables) >= 2 for tables in seen)
    for prev, tables in zip(seen, seen[1:]):
        assert tables[0].numel() == min(cap, sum(t.numel() for t in prev))
    assert rep["fold-merge"]["calls"] == rep["table-fold"]["calls"] == \
        len(seen)
    assert rep["fold-merge"]["rows"] == sum(map(len, seen))
    assert rep["table-fold"]["rows"] == sum(t.numel() for tables in seen
                                            for t in tables)


def test_the_module_merges_on_the_cpu_without_nvcc(tmp_path):
    """Importing the module and merging on the CPU need no compiler; only
    build(), which the first merge on the card calls, does."""
    code = ("import torch\n"
            "from bionumpy_tpu_torch.ops import table_kernels as tk\n"
            "k = torch.tensor([1, 4, tk.SENTINEL])\n"
            "c = torch.tensor([2, 3, 0])\n"
            "print(tk.merge_tables([(k, c), (k[:2] + 1, c[:2])], 8)[1]"
            ".tolist())\n"
            "try:\n"
            "    tk.build()\n"
            "except RuntimeError as err:\n"
            "    print('BUILD', 'nvcc not found' in str(err))\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # keys 1 and 4 of the first table, 2 and 5 of the second, then the
    # sentinel's row
    assert proc.stdout.split() == ["[2,", "2,", "3,", "3,", "0]", "BUILD",
                                   "True"]


def run_length(s, rows):
    """(keys, counts, meta) of a NumPy run-length encoding of the sorted
    keys `s` below the sentinel, in `rows` rows padded with (S, 0); past
    `rows` runs the last row's count is 0 less its run's start, the JAX
    package's truncation."""
    live = s[s != S]
    uniq, counts = np.unique(live, return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    out_k = np.full(rows, S, np.int64)
    out_c = np.zeros(rows, np.int64)
    m = min(len(uniq), rows)
    out_k[:m], out_c[:m] = uniq[:m], counts[:m]
    if len(uniq) > rows > 0:
        out_c[rows - 1] = -starts[rows - 1]
    return out_k, out_c, np.array([len(uniq), len(live)], np.int64)


TILE = 2048  # the kernel's keys a tile


def _sorted_case(name, rng):
    """Sorted int64 keys of one named case (the sentinel last)."""
    if name == "all-sentinel":
        s = np.full(5000, S)
    elif name == "no-sentinel":
        s = rng.integers(0, 1 << 40, 7000)
    elif name == "one-key":
        s = np.array([42])
    elif name == "one-key-and-sentinels":
        s = np.array([42] + [S] * 9)
    elif name == "all-equal":
        s = np.full(6000, 9)
    elif name == "runs-of-one":
        s = np.concatenate([np.arange(5000) * 3, np.full(300, S)])
    elif name == "runs-past-tiles":  # runs of 2.5-4.5 tiles
        lengths = rng.integers(5000, 9000, 6)
        s = np.concatenate([np.repeat(rng.choice(1 << 30, 6, replace=False),
                                      lengths), np.full(1234, S)])
    elif name == "odd-n":  # not a multiple of a tile, runs of 1-6
        s = rng.integers(0, 2000, 3 * TILE + 777)
        s[rng.random(len(s)) < 0.1] = S
    elif name == "extremes":  # the least int64, 0 and the key below S
        s = np.concatenate([[-(1 << 63), -1, 0, 0, S - 1, S - 1],
                            rng.integers(-(1 << 62), 1 << 62, 500), [S]])
    else:
        raise KeyError(name)
    return np.sort(np.asarray(s, np.int64))


RUN_CASES = ["all-sentinel", "no-sentinel", "one-key", "one-key-and-sentinels",
             "all-equal", "runs-of-one", "runs-past-tiles", "odd-n",
             "extremes"]


def _rows(kind, s):
    """The rows of one kind for keys `s`: every key, above, at or below
    the runs, or one row."""
    n, n_unique = len(s), len(np.unique(s[s != S]))
    rows = {"all": n, "above": min(n, n_unique + 3),
            "equal": max(1, n_unique), "below": max(1, n_unique - 1),
            "one": 1}[kind]
    assert 0 < rows <= n
    return rows


@pytest.mark.parametrize("kind", ["all", "above", "equal", "below", "one"])
@pytest.mark.parametrize("name", RUN_CASES)
def test_plain_run_table_matches_a_run_length_encoding(name, kind):
    s = _sorted_case(name, np.random.default_rng(sum(map(ord, name))))
    rows = _rows(kind, s)
    keys, counts, meta = tk.run_table_plain(torch.from_numpy(s.copy()), rows)
    want_k, want_c, want_meta = run_length(s, rows)
    assert keys.dtype == counts.dtype == meta.dtype == torch.int64
    assert keys.shape == counts.shape == (rows,) and meta.shape == (2,)
    np.testing.assert_array_equal(keys.numpy(), want_k)
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_array_equal(meta.numpy(), want_meta)
    if want_meta[0] > rows:  # the truncated last row, as before
        assert int(counts[-1]) <= 0


def test_run_table_takes_the_plain_version_for_cpu_tensors():
    s = torch.from_numpy(_sorted_case("odd-n", np.random.default_rng(3)))
    tk.reset_launches()
    instrument.reset()
    got = tk.run_table(s, 1000)
    rep = instrument.report()
    want = tk.run_table_plain(s, 1000)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tk.LAUNCHES == {"merge_tables_kernel": 0, "run_table_kernel": 0}
    assert rep["run-table"]["calls"] == 1
    assert rep["run-table"]["rows"] == s.numel()


@pytest.mark.parametrize("bad", ["dtype", "device", "contiguous", "2-d",
                                 "rows-past", "rows-negative"])
def test_run_table_refuses_what_the_kernel_does_not_take(bad):
    s, rows = torch.arange(16, dtype=torch.int64), 8
    if bad == "dtype":
        s = s.to(torch.int32)
    elif bad == "device":  # a device without the kernel
        s = torch.empty(16, dtype=torch.int64, device="meta")
    elif bad == "contiguous":
        s = torch.arange(32, dtype=torch.int64)[::2]
    elif bad == "2-d":
        s = s.reshape(4, 4)
    elif bad == "rows-past":
        rows = 17
    else:
        rows = -1
    with pytest.raises(ValueError):
        tk.run_table(s, rows)


def _old_sentinel_table(keys, cap):
    """sentinel_table as it was written before the run table: the sort's
    runs compacted by heads_first, counts from the run starts."""
    uniq, run_starts, n_unique, n_valid = kmers.sorted_runs_from_keys(
        keys, min(cap, keys.numel()))
    rows = run_starts.numel()
    cnt = kmers.counts_from_runs(run_starts, n_unique, n_valid, rows)
    live = torch.arange(rows) < n_unique
    return (torch.where(live, uniq, S), cnt, torch.stack([n_unique, n_valid]))


def _old_whole_table(keys, cap):
    """whole_table as it was written before the run table."""
    s, _, is_start, n_unique, n_valid = kmers.sort_runs(keys)

    def compacted(rows):
        uniq, run_starts = kmers.compact_runs(s, is_start, rows)
        return uniq, kmers.counts_from_runs(run_starts, n_unique, n_valid,
                                            rows)

    rows = min(cap, keys.numel())
    uniq, counts = compacted(rows)
    n = int(n_unique)
    if n > rows:
        uniq, counts = compacted(min(kmers.bucket_size(n, 1), keys.numel()))
    return uniq[:n], counts[:n], torch.stack([n_unique, n_valid])


def _unsorted_keys(seed, n=20_000, hi=6000, share=0.25):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, n)
    keys[rng.random(n) < share] = S
    return torch.from_numpy(keys)


@pytest.mark.parametrize("cap", [1 << 20, 20_000, 5600, 4000, 1])
@pytest.mark.parametrize("table", ["sentinel_table", "whole_table"])
def test_tables_through_the_run_table_are_the_tables_of_before(
        monkeypatch, table, cap):
    seen = []

    def spy(sorted_keys, rows):
        seen.append(rows)
        return tk.run_table(sorted_keys, rows)

    monkeypatch.setattr(kmers, "run_table", spy)
    keys = _unsorted_keys(11)
    instrument.reset()
    got = getattr(kmers, table)(keys, cap)
    rep = instrument.report()
    old = _old_sentinel_table if table == "sentinel_table" \
        else _old_whole_table
    want = old(keys, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    n_unique = int(want[2][0])
    rows = min(cap, keys.numel())
    # whole_table compacts again from the same sort past `rows`
    again = table == "whole_table" and n_unique > rows
    assert seen == [rows] + ([min(kmers.bucket_size(n_unique, 1),
                                  keys.numel())] if again else [])
    assert rep["sort"]["calls"] == 1
    assert rep["run-table"]["calls"] == len(seen)
    assert rep.get("cap-rerun", {}).get("calls", 0) == again


@pytest.mark.parametrize("k,cap", [(9, 1 << 14), (13, 500)])
def test_sentinel_table_through_the_run_table_matches_jax(monkeypatch, k,
                                                           cap):
    rng = np.random.default_rng(k)
    lengths = rng.integers(0, 90, 200)
    flat = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    words, ends, n = kmers.prepare_packed(flat, lengths)
    lo, hi, cnt, meta = jkmers.kmer_sentinel_table_packed(
        jnp.asarray(words), jnp.asarray(ends), k, n, cap)
    calls = []
    monkeypatch.setattr(kmers, "run_table",
                        lambda s, rows: calls.append(rows)
                        or tk.run_table(s, rows))
    keys, counts, tmeta = kmers.kmer_sentinel_table_packed(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(ends), k,
        n, cap)
    jkeys = np.where((np.asarray(lo) == 0xFFFFFFFF)
                     & (np.asarray(hi) == 0xFFFFFFFF), S,
                     np.asarray(lo).astype(np.int64)
                     | (np.asarray(hi).astype(np.int64) << 32))
    assert len(calls) == 1
    np.testing.assert_array_equal(keys.numpy(), jkeys)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(cnt))
    np.testing.assert_array_equal(tmeta.numpy(), np.asarray(meta))
    if cap == 500:
        assert int(tmeta[0]) > cap
