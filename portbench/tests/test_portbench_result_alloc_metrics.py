"""The readers of the motif call's `result` spans and the page-locked
fetch's `fetch-alloc` spans, on synthetic stages: their host time per
job, and nothing in a program without the spans."""
from types import SimpleNamespace

import pytest

import tiny  # noqa: F401
from portbench.registry import HERE, Registry

REG = Registry([HERE])


def metric(name):
    return REG.metric(name).read


def jobs(n):
    return [SimpleNamespace(start=i, end=i + 1, n_bases=1000, n_reads=10,
                            ok=True) for i in range(n)]


def test_result_ms_per_job():
    stages = {"result": {"seconds": 0.03, "calls": 6, "rows": 900},
              "get_motif_matches": {"seconds": 0.05, "call": True},
              "fetch-alloc": {"seconds": 1.0}}
    ctx = SimpleNamespace(stages=stages, jobs=jobs(3))
    assert metric("result_ms_per_job")(ctx) == pytest.approx(10.0)


def test_fetch_alloc_ms_per_job():
    stages = {"fetch-alloc": {"seconds": 2.9, "calls": 60,
                              "bytes": 60 * 4_294_967_296},
              "fetch-host-alloc": {"seconds": 0.0, "calls": 2},
              "D2H": {"seconds": 5.0, "device_seconds": 5.0},
              "result": {"seconds": 1.0}}
    ctx = SimpleNamespace(stages=stages, jobs=jobs(58))
    assert metric("fetch_alloc_ms_per_job")(ctx) == pytest.approx(
        2.9e3 / 58)


@pytest.mark.parametrize("name", ["result_ms_per_job",
                                  "fetch_alloc_ms_per_job"])
def test_readers_find_nothing(name):
    # a program without the spans (the pageable fetch, another call)
    for stages in ({}, {"D2H": {"seconds": 1.0}, "fetch-pinned":
                        {"seconds": 0.0, "calls": 3},
                        "count_kmers": {"seconds": 1.0, "call": True}}):
        ctx = SimpleNamespace(trace=None, jobs=jobs(1), gbases=1e-6,
                              stages=stages)
        assert metric(name)(ctx) is None
    # spans but no job in the window
    ctx = SimpleNamespace(jobs=[], stages={"result": {"seconds": 1.0},
                                           "fetch-alloc": {"seconds": 1.0}})
    assert metric(name)(ctx) is None
