"""The readers of the program's spans on synthetic stages and traces:
device idle inside the `upload` ranges, sorted keys per base, the fetch
rate and the calls' self time; each finds nothing in a program without
the spans.  A traced run on the CPU reports the span metrics of its
cell."""
import time
from types import SimpleNamespace

import pytest

import tiny
from portbench.harness import run_cell
from portbench.registry import HERE, Registry
from portbench.trace import Trace

REG = Registry([HERE])


def metric(name):
    return REG.metric(name).read


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def jobs(n):
    return [SimpleNamespace(start=i, end=i + 1, n_bases=1000, n_reads=10,
                            ok=True) for i in range(n)]


def upload_trace():
    return Trace([
        ev("portbench.job", "user_annotation", 0, 1000),
        ev("portbench.job", "user_annotation", 1000, 1000),
        # job 1: upload 100-400 (pack 100-300 idle, H2D copy 300-380)
        ev("upload", "user_annotation", 100, 300),
        ev("pack", "user_annotation", 100, 200),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 300, 80),
        # job 2: upload 1100-1300, a kernel from before it runs to 1150
        ev("upload", "user_annotation", 1100, 200),
        ev("kmer_keys_kernel", "kernel", 1050, 100),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1250, 50),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1500, 400),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 100),
        # an upload outside the window counts for nothing
        ev("upload", "user_annotation", 3000, 100),
    ])


def test_upload_idle_ms_per_job():
    ctx = SimpleNamespace(trace=upload_trace(), jobs=jobs(2))
    # job 1: 300 - 80 = 220 us idle; job 2: 200 - 50 - 50 = 100 us
    assert metric("upload_idle_ms_per_job")(ctx) == pytest.approx(
        (220 + 100) / 1e3 / 2)


def test_upload_idle_with_a_busy_upload():
    t = Trace([ev("portbench.job", "user_annotation", 0, 100),
               ev("upload", "user_annotation", 10, 50),
               ev("k", "kernel", 0, 100)])
    assert metric("upload_idle_ms_per_job")(
        SimpleNamespace(trace=t, jobs=jobs(1))) == 0


def test_sorted_keys_per_base():
    ctx = SimpleNamespace(stages={"sort": {"rows": 3 << 20, "calls": 2}},
                          gbases=1.5e-3)
    assert metric("sorted_keys_per_base")(ctx) == pytest.approx(
        (3 << 20) / 1.5e6)


def test_fetch_gb_per_s():
    ctx = SimpleNamespace(trace=upload_trace(),
                          stages={"D2H": {"bytes": 10 ** 6, "rows": 62500}})
    # DtoH: 600-700 and 1500-1900 inside the window: 500 us
    assert metric("fetch_gb_per_s")(ctx) == pytest.approx(1e6 / 500e-6 / 1e9)


def test_call_self_ms_per_job():
    stages = {"count_kmers": {"self_seconds": 0.004, "call": True},
              "get_kmers": {"self_seconds": 0.002, "call": True},
              "sort": {"self_seconds": 1.0}}
    ctx = SimpleNamespace(stages=stages, jobs=jobs(3))
    assert metric("call_self_ms_per_job")(ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["upload_idle_ms_per_job",
                                  "sorted_keys_per_base", "fetch_gb_per_s",
                                  "call_self_ms_per_job"])
def test_span_readers_find_nothing(name):
    # a program without the spans: no stages, no upload ranges
    bare = Trace([ev("portbench.job", "user_annotation", 0, 100),
                  ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
                     10, 20)])
    for trace in (None, bare):
        ctx = SimpleNamespace(trace=trace, jobs=jobs(1), gbases=1e-6,
                              stages={"D2H-table": {"seconds": 1.0}})
        assert metric(name)(ctx) is None


@pytest.mark.parametrize("cell,expect,absent", [
    ("minimizer21-genome", ["upload_idle_ms_per_job", "sorted_keys_per_base",
                            "call_self_ms_per_job"], []),
    ("kmer31-resident", ["sorted_keys_per_base", "call_self_ms_per_job"],
     ["upload_idle_ms_per_job"]),
])
def test_traced_cpu_run_reports_span_metrics(tmp_path, cell, expect,
                                              absent):
    reg = tiny.registry(tmp_path)
    res = run_cell(reg, cell, 5, 0.3, True, "cpu", time.perf_counter(),
                   log=lambda m: None)
    assert res["correct"], res
    for name in expect:
        assert res["metrics"][name]["value"] > 0, name
    for name in absent:
        assert name not in res["metrics"]
