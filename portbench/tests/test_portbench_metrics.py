"""The metric arithmetic on synthetic jobs and event lists: the roofline
bytes, the union-of-intervals idle share, the window rate, and the
trace's window, busy time and breakdown."""
from types import SimpleNamespace

import pytest

import tiny  # noqa: F401
from portbench.registry import HERE, Registry
from portbench.trace import Trace, gaps, merged, union_length

REG = Registry([HERE])


def metric(name):
    return REG.metric(name).read


def job(start, end, n_bases=1000, n_reads=10, ok=True):
    return SimpleNamespace(start=start, end=end, n_bases=n_bases,
                           n_reads=n_reads, ok=ok)


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic_trace():
    return Trace([
        ev("portbench.job", "user_annotation", 100, 400),
        ev("portbench.job", "user_annotation", 500, 500),
        ev("aten::sort", "cpu_op", 120, 60),
        ev("void kmer_keys_kernel(int const*, int)", "kernel", 110, 40),
        ev("cub::DeviceRadixSortOnesweepKernel", "kernel", 140, 60),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 300, 100),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 520, 30),
        ev("kmer_keys_kernel", "kernel", 600, 40),
        ev("Memset (Device)", "gpu_memset", 990, 50),
        ev("outside the window", "kernel", 0, 50),
        ev("portbench.job", "gpu_user_annotation", 100, 900),
    ])


def test_intervals():
    assert merged([(5, 7), (1, 3), (2, 4)]) == [(1, 4), (5, 7)]
    assert union_length([(1, 3), (2, 4), (10, 20)], 0, 12) == 5
    assert gaps([(1, 3), (2, 4), (10, 20)], 0, 12) == [(0, 1), (4, 10)]
    assert gaps([], 0, 5) == [(0, 5)]


def test_trace_window_busy_and_breakdown():
    t = synthetic_trace()
    assert (t.lo, t.hi) == (100, 1000)
    assert t.window_s == pytest.approx(900e-6)
    # 110-200, 300-400, 520-550, 600-640, 990-1000 (clipped)
    assert t.busy_s == pytest.approx(270e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)",
                                   pytest.approx(100e-6)]
    assert len(bd["device_ops"]) == 6
    idle = dict(bd["idle_gaps"])
    assert idle["host outside torch ops, in a job"] == pytest.approx(
        (10 + 100 + 120 + 50 + 350) * 1e-6)
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)


def test_gap_in_a_long_job_is_named_by_the_job():
    # more host events than the lookback between the job's start and
    # the gap
    events = [ev("portbench.job", "user_annotation", 0, 100_000),
              ev("kmer_keys_kernel", "kernel", 99_990, 5)]
    events += [ev("aten::add", "cpu_op", 10 + 10 * i, 2)
               for i in range(5000)]
    idle = dict(Trace(events).breakdown()["idle_gaps"])
    assert list(idle) == ["host outside torch ops, in a job"]


def test_trace_metrics():
    t = synthetic_trace()
    ctx = SimpleNamespace(trace=t, jobs=[job(0, 1, 2000, 20),
                                         job(1, 2, 2000, 20)],
                          gbases=4000 / 1e9,
                          peaks={"hbm_bytes_per_s": 3.35e12})
    assert metric("device_idle_share")(ctx) == pytest.approx(
        100 * (1 - 270 / 900))
    assert metric("fetch_d2h_ms_per_job")(ctx) == pytest.approx(0.1 / 2)
    assert metric("table_device_ms_per_gbase")(ctx) == pytest.approx(
        0.06 / 4000e-9)
    need = 2 * (2000 // 4 + 4 * 20 + 8 * 2000)
    assert metric("kmer_keys_roofline")(ctx) == pytest.approx(
        100 * need / 3.35e12 / 80e-6)


def test_readers_find_nothing():
    empty = SimpleNamespace(trace=None, jobs=[], gbases=0, stages={},
                            peaks={"hbm_bytes_per_s": 1.0})
    for name in ("device_idle_share", "fetch_d2h_ms_per_job",
                 "table_device_ms_per_gbase", "kmer_keys_roofline",
                 "ingest_thread_s_per_gbase"):
        assert metric(name)(empty) is None
    idle = SimpleNamespace(trace=Trace([ev("portbench.job",
                                           "user_annotation", 0, 10)]),
                           jobs=[job(0, 1)], gbases=1e-6,
                           peaks={"hbm_bytes_per_s": 1.0})
    for name in ("device_idle_share", "fetch_d2h_ms_per_job",
                 "table_device_ms_per_gbase", "kmer_keys_roofline"):
        assert metric(name)(idle) is None


def test_host_clock_metrics():
    jobs = [job(i * 0.1, i * 0.1 + 0.05 + 0.001 * i, 10 ** 6)
            for i in range(100)]
    jobs.append(job(10.0, 12.0, 10 ** 6, ok=False))
    ctx = SimpleNamespace(jobs=jobs, window_s=12.0, setup_s=3.5)
    assert metric("setup_s")(ctx) == 3.5
    # the failed job's bases count for nothing; its time counts
    assert metric("job_mbases_per_s")(ctx) == pytest.approx(100 / 12.0)


def test_ingest_per_gbase():
    ctx = SimpleNamespace(stages={"inflate+parse": {"seconds": 3.0},
                                  "read": {"seconds": 0.5},
                                  "H2D": {"seconds": 9.0}}, gbases=0.5)
    assert metric("ingest_thread_s_per_gbase")(ctx) == pytest.approx(7.0)
