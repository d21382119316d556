"""bionumpy_tpu_torch.instrument: nesting and self time, call ids across
threads, counts on spans, the cap-rerun counter, the page-locked fetch's
`fetch-alloc` span and counters (fetch-pinned, fetch-host-alloc), the
no-op switch, the
profiler's ranges, the bounded span log, lazy device time, and the one
fetch helper against the three fetches it replaced.  CPU only, no JAX;
the `cuda` test skips without a card:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_instrument.py
"""
import functools
import gzip
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import bionumpy_tpu_torch as bt
from bionumpy_tpu_torch import instrument
from bionumpy_tpu_torch import pipeline as tpipe
from bionumpy_tpu_torch.ops import kmers as tkmers
from bionumpy_tpu_torch.ops.device import PINNED_MIN_BYTES, fetch_rows


@pytest.fixture(autouse=True)
def fresh():
    instrument.reset()
    yield
    instrument.reset()


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def reads(n_rows=400, length=150, seed=3):
    rng = np.random.default_rng(seed)
    lengths = np.full(n_rows, length)
    lengths[::7] = rng.integers(0, 40, len(lengths[::7]))
    flat = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    return bt.EncodedRaggedArray(bt.EncodedArray(flat, bt.DNAEncoding),
                                 lengths)


def fastq_gz(path, n_reads=600, seed=4, per_member=100):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for m in range(0, n_reads, per_member):
            text = "".join(
                f"@r{i}\n{''.join(rng.choice(list('ACGT'), 90))}\n+\n"
                f"{'F' * 90}\n" for i in range(m, m + per_member))
            f.write(gzip.compress(text.encode()))
    return str(path)


def test_nesting_and_self_seconds():
    with instrument.stage("outer"):
        time.sleep(0.02)
        with instrument.stage("inner"):
            time.sleep(0.03)
            with instrument.stage("leaf"):
                time.sleep(0.01)
    rep = instrument.report()
    assert rep["outer"]["seconds"] >= 0.06
    assert rep["outer"]["self_seconds"] == pytest.approx(
        rep["outer"]["seconds"] - rep["inner"]["seconds"], abs=1e-5)
    assert rep["inner"]["self_seconds"] == pytest.approx(
        rep["inner"]["seconds"] - rep["leaf"]["seconds"], abs=1e-5)
    assert rep["leaf"]["self_seconds"] == rep["leaf"]["seconds"]
    assert 0.015 < rep["outer"]["self_seconds"] < rep["outer"]["seconds"]
    spans = by_name(instrument.spans())
    assert spans["leaf"][0]["parent"] == "inner"
    assert spans["inner"][0]["parent"] == "outer"
    assert spans["outer"][0]["parent"] is None
    # closed innermost first
    assert [s["name"] for s in instrument.spans()] == ["leaf", "inner",
                                                       "outer"]


def test_spans_outside_a_call_carry_no_id():
    with instrument.stage("alone"):
        pass
    assert instrument.spans()[0]["call"] is None
    assert "call" not in instrument.report()["alone"]


@instrument.call_span
def _entry(pool, nested=False):
    with instrument.stage("here"):
        if nested:
            return _entry(pool)
    fut = pool.submit(instrument.carried(_worker_task))
    return fut.result()


def _worker_task():
    with instrument.stage("worker"):
        time.sleep(0.02)
    return threading.get_ident()


def test_one_id_per_call_and_on_pool_threads():
    with ThreadPoolExecutor(2) as pool:
        worker_thread = _entry(pool)
        _entry(pool, nested=True)
    spans = instrument.spans()
    calls = [s for s in spans if s["name"] == "_entry"]
    assert len(calls) == 3
    first, second = calls[0]["call"], calls[2]["call"]
    assert first != second and None not in (first, second)
    # the nested call draws no id of its own
    assert calls[1]["call"] == second and calls[1]["parent"] == "here"
    workers = [s for s in spans if s["name"] == "worker"]
    assert [w["call"] for w in workers] == [first, second]
    assert workers[0]["thread"] == worker_thread != calls[0]["thread"]
    assert workers[0]["parent"] is None
    rep = instrument.report()
    assert rep["_entry"]["call"] is True
    # the worker ran beside the call: its 20 ms stay in the call's self
    # time, which loses only its same-thread child "here"
    assert rep["_entry"]["self_seconds"] >= 0.04
    assert rep["_entry"]["self_seconds"] == pytest.approx(
        rep["_entry"]["seconds"] - rep["here"]["seconds"], abs=1e-5)


def test_pipeline_call_id_reaches_its_threads(tmp_path):
    path = fastq_gz(tmp_path / "r.fq.gz")
    counts, stats = bt.count_kmers_fastq(path, 21, device="cpu",
                                         device_parse=False, n_threads=2)
    assert stats["n_reads"] == 600
    spans = instrument.spans()
    ids = {s["call"] for s in spans}
    assert len(ids) == 1 and None not in ids
    names = by_name(spans)
    assert names["count_kmers_fastq"][0]["parent"] is None
    # host spans ran on other threads than the call's
    call_thread = names["count_kmers_fastq"][0]["thread"]
    assert {s["thread"] for s in spans} - {call_thread}
    assert {"read", "H2D", "dispatch", "device-merge", "D2H-table",
            "D2H-meta", "D2H", "sort"} <= set(names)
    assert names["D2H"][0]["parent"] == "D2H-table"
    assert names["D2H"][0]["rows"] == len(counts.label_codes)


def test_rows_and_bytes():
    with instrument.stage("given", n_bytes=100, rows=7):
        pass
    with instrument.stage("given", n_bytes=50, rows=3):
        pass
    with instrument.stage("set") as span:
        span.bytes, span.rows = 64, 8
    instrument.add("counter", 0.0)
    instrument.add("counter", 0.0, n_bytes=5, rows=2)
    rep = instrument.report()
    assert (rep["given"]["bytes"], rep["given"]["rows"],
            rep["given"]["calls"]) == (150, 10, 2)
    assert (rep["set"]["bytes"], rep["set"]["rows"]) == (64, 8)
    assert rep["counter"] == {"seconds": 0.0, "calls": 2,
                              "self_seconds": 0.0, "bytes": 5, "rows": 2}


def test_count_kmers_fetches_its_rows():
    seqs = reads()
    counts = bt.count_kmers(seqs, 31, device="cpu")
    rep = instrument.report()
    n = len(counts.label_codes)
    assert rep["D2H"]["rows"] == n and rep["D2H"]["bytes"] == 16 * n
    assert rep["sort"]["rows"] == 1 << 16  # the bucket: padding too
    assert "cap-rerun" not in rep
    # a CPU fetch is pageable: no block taken, the fetch counters at zero
    assert "fetch-pinned" not in rep and "fetch-host-alloc" not in rep
    assert "fetch-alloc" not in rep
    assert rep["count_kmers"]["call"] is True
    assert rep["upload"]["calls"] == 1
    assert rep["pack"]["bytes"] == rep["H2D"]["bytes"] > 0
    assert {s["parent"] for s in instrument.spans()
            if s["name"] in ("flatten", "pack", "H2D")} == {"upload"}
    # resident: a second call uploads nothing
    bt.count_kmers(seqs, 31, device="cpu")
    assert instrument.report()["upload"]["calls"] == 1


def test_cap_rerun_counted(monkeypatch):
    seqs = reads()
    want = bt.count_kmers(seqs, 31, device="cpu")
    assert len(want.label_codes) > 1024
    monkeypatch.setattr(tkmers, "sparse_count_tables", functools.partial(
        tkmers.sparse_count_tables, cap=1024))
    instrument.reset()
    got = bt.count_kmers(seqs, 31, device="cpu")
    assert np.array_equal(got.label_codes, want.label_codes)
    assert np.array_equal(got.counts, want.counts)
    rep = instrument.report()
    # compacted again from the one sort, after the one wait
    assert rep["cap-rerun"]["calls"] == 1
    assert rep["sort"]["calls"] == 1 and rep["sort"]["rows"] == 1 << 16
    assert rep["D2H-meta"]["calls"] == 1
    rerun = by_name(instrument.spans())["cap-rerun"][0]
    assert rerun["parent"] == "count_kmers" and rerun["call"] is not None


def test_minimizer_cap_reruns_counted():
    seqs = reads(n_rows=200)
    bt.count_minimizers_with_gc(seqs, 11, 15, cap=64, device="cpu")
    rep = instrument.report()
    assert rep["cap-rerun"]["calls"] == rep["sort"]["calls"] == 1
    assert rep["D2H"]["calls"] == 1


def test_disabled_records_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(instrument, "ENABLED", False)
    seqs = reads()
    bt.count_kmers(seqs, 31, device="cpu")
    bt.count_minimizers_with_gc(seqs, 21, 30, device="cpu")
    bt.count_kmers_fastq(fastq_gz(tmp_path / "r.fq.gz"), 21, device="cpu",
                         device_parse=False)
    with instrument.stage("x") as span:
        span.rows = 3
    instrument.add("y", 1.0)
    assert instrument.report() == {}
    assert instrument.spans() == []


def test_profiler_ranges_only_while_recording(monkeypatch, tmp_path):
    opened = []
    real = torch.autograd.profiler.record_function

    class Spy(real):
        def __init__(self, name, *args):
            opened.append(name)
            super().__init__(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    seqs = reads()
    bt.count_kmers(seqs, 31, device="cpu")
    assert opened == []
    from torch.profiler import ProfilerActivity, profile
    bt.ops.resident.invalidate(seqs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bt.count_kmers(seqs, 31, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events
              if e.get("cat") == "user_annotation"}
    assert {"count_kmers", "upload", "flatten", "pack", "H2D", "sort",
            "D2H-meta", "D2H"} <= set(ranges) <= set(opened)
    # nested on the trace's clock: the upload inside the call
    call, up = ranges["count_kmers"], ranges["upload"]
    assert call["ts"] <= up["ts"] and \
        up["ts"] + up["dur"] <= call["ts"] + call["dur"]
    n = len(opened)
    bt.count_kmers(seqs, 31, device="cpu")
    assert len(opened) == n


def test_span_log_is_bounded_and_reset_clears_it():
    for i in range(instrument.LOG + 10):
        with instrument.stage("s", rows=1):
            pass
    spans = instrument.spans()
    assert len(spans) == instrument.LOG
    assert instrument.report()["s"]["calls"] == instrument.LOG + 10
    instrument.reset()
    assert instrument.spans() == [] and instrument.report() == {}


class FakeEvent:
    """A CUDA event's interface, completed by the test."""
    clock = 0.0

    def __init__(self):
        self.done = False
        self.at = None

    def record(self):
        FakeEvent.clock += 1.0
        self.at = FakeEvent.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3  # ms


def test_device_pairs_resolve_lazily_and_are_bounded(monkeypatch):
    made = []

    def new_event():
        made.append(FakeEvent())
        return made[-1]

    monkeypatch.setattr(instrument, "_cuda_ready", lambda: True)
    monkeypatch.setattr(instrument, "_new_event", new_event)
    monkeypatch.setattr(instrument, "PENDING", 3)
    for _ in range(5):
        with instrument.stage("dev", device=True):
            pass
    with instrument.stage("host"):  # no pair
        pass
    rep = instrument.report()
    assert len(made) == 10
    assert rep["dev"]["device_unresolved"] == 2
    assert "device_seconds" not in rep["dev"]
    for e in made:
        e.done = True
    # resolved at the next span's entry, without a report
    with instrument.stage("next"):
        pass
    assert all(s["device_seconds"] == pytest.approx(1.0)
               for s in instrument.spans()[2:5])
    rep = instrument.report()
    assert rep["dev"]["device_seconds"] == pytest.approx(3.0)
    assert "device_seconds" not in rep["host"]
    # pairs resolve oldest first and stop at the first still running
    made.clear()
    for _ in range(2):
        with instrument.stage("dev2", device=True):
            pass
    made[3].done = True  # the second pair's end only
    assert "device_seconds" not in instrument.report()["dev2"]
    made[1].done = True
    assert instrument.report()["dev2"]["device_seconds"] == \
        pytest.approx(2.0)


def test_fetch_helper_equals_the_old_sites():
    g = torch.Generator().manual_seed(5)
    keys = torch.randint(0, 1 << 62, (1000,), generator=g)
    cnt = torch.randint(1, 100, (1000,), generator=g)
    gc = torch.randint(0, 1000, (37,), generator=g, dtype=torch.int32)
    n = 613
    # ops/kmers.sparse_count_tables and pipeline._fetch_acc
    table = torch.stack([keys[:n], cnt[:n]]).cpu().numpy()
    rows = fetch_rows(keys[:n], cnt[:n], rows=n)
    assert np.array_equal(rows[:n].view(np.uint64), table[0].view(np.uint64))
    assert np.array_equal(rows[n:], table[1])
    assert rows.dtype == table.dtype == np.int64
    # sequence/minimizers._live_rows
    old = torch.cat([p.to(torch.int64) for p in
                     (keys[:n], cnt[:n], gc)]).cpu().numpy()
    assert np.array_equal(fetch_rows(keys[:n], cnt[:n], gc, rows=n), old)
    rep = instrument.report()["D2H"]
    assert rep["rows"] == 2 * n and rep["bytes"] == 8 * (4 * n + 37)
    # pipeline._fetch_acc as a whole
    acc = (torch.cat([keys[:n], torch.full((5,), tkmers.SENTINEL)]),
           torch.cat([cnt[:n], torch.zeros(5, dtype=torch.int64)]),
           torch.tensor(n))
    h, c = tpipe._fetch_acc(acc, n + 5)
    assert np.array_equal(h, table[0].view(np.uint64))
    assert np.array_equal(c, table[1])


def test_threads_lose_no_update():
    n_threads, n_spans = 32, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with instrument.stage("a", rows=1):
                    with instrument.stage("b", n_bytes=2):
                        pass
                instrument.add("c", 0.0, rows=1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rep = instrument.report()
    total = n_threads * n_spans
    assert rep["a"]["calls"] == rep["a"]["rows"] == total
    assert rep["b"]["bytes"] == 2 * total
    assert rep["c"]["rows"] == total
    assert all(s["parent"] == "a" for s in instrument.spans()
               if s["name"] == "b")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_seconds_resolve_without_a_synchronise(cuda, monkeypatch):
    x = torch.randn(4096, 4096, device=cuda)
    torch.cuda.synchronize()
    instrument.reset()

    def forbidden(*args, **kwargs):
        raise AssertionError("the hot path synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", forbidden)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", forbidden)
    for _ in range(20):
        with instrument.stage("matmul", device=True):
            y = x @ x
        with instrument.stage("host"):
            pass
    monkeypatch.undo()
    torch.cuda.synchronize()
    rep = instrument.report()
    assert rep["matmul"]["device_seconds"] > rep["matmul"]["seconds"] / 100
    assert "device_unresolved" not in rep["matmul"]
    assert all(s["device_seconds"] > 0 for s in instrument.spans()
               if s["name"] == "matmul")
    # a table fetch on the card: its bytes, rows and device time
    seqs = reads()
    counts = bt.count_kmers(seqs, 31, device=cuda)
    torch.cuda.synchronize()
    rep = instrument.report()
    assert rep["D2H"]["rows"] == len(counts.label_codes)
    for name in ("H2D", "sort", "D2H", "D2H-meta"):
        assert rep[name]["device_seconds"] > 0, name
    del y


@pytest.mark.cuda
def test_fetch_counters_on_the_card(cuda):
    seqs = reads(n_rows=4000)
    first = bt.count_kmers(seqs, 31, device=cuda)
    n_bytes = 16 * len(first.label_codes)
    assert n_bytes >= PINNED_MIN_BYTES
    del first
    instrument.reset()
    held = bt.count_kmers(seqs, 31, device=cuda)
    rep = instrument.report()
    # the dropped table's block is taken again
    assert rep["fetch-pinned"]["calls"] == rep["fetch-alloc"]["calls"] == 1
    assert rep["fetch-pinned"]["bytes"] == rep["fetch-alloc"]["bytes"] == \
        n_bytes
    assert "fetch-host-alloc" not in rep
    # with that table held, the next fetch needs a block of its own
    again = bt.count_kmers(seqs, 31, device=cuda)
    rep = instrument.report()
    assert rep["fetch-pinned"]["calls"] == rep["fetch-alloc"]["calls"] == 2
    assert rep.get("fetch-host-alloc", {"calls": 0})["calls"] <= 1
    assert np.array_equal(held.counts, again.counts)
    names = by_name(instrument.spans())
    assert {s["parent"] for s in names["fetch-pinned"]} == {"D2H"}
    assert {s["parent"] for s in names["fetch-alloc"]} == \
        {s["parent"] for s in names["D2H"]}
    assert {s["parent"] for s in names.get("fetch-host-alloc", [])} <= \
        {"fetch-alloc"}
    # each block is taken before its copy starts, the copy alone in D2H
    for alloc, d2h in zip(names["fetch-alloc"], names["D2H"]):
        assert alloc["end"] <= d2h["start"]
    # small tables stay pageable and uncounted
    instrument.reset()
    bt.count_kmers(reads(n_rows=40), 31, device=cuda)
    assert "fetch-pinned" not in instrument.report()
    assert "fetch-alloc" not in instrument.report()
