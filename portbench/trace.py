"""The device trace of a window: torch.profiler's chrome trace reduced to
device intervals, the window's bounds, busy time as the union of the
intervals, and the breakdown of device operations and idle gaps.

Times are in microseconds on the trace's clock until `Trace` turns them
into seconds.  A device interval is a kernel, a copy or a memset; the
window is the span from the first job's annotation to the last one's
end.
"""
from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

JOB = "portbench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def merged(intervals):
    """Sorted, disjoint (start, end) covering the same time."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clipped(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def union_length(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(clipped(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float):
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in merged(clipped(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


class HostIndex:
    """Host events sorted by start, to name what the host was doing at a
    moment: the innermost torch op or runtime call (latest start) over
    it, else whether a job's span covers it."""

    LOOKBACK = 4096

    def __init__(self, events, jobs):
        events = sorted(events, key=lambda x: x[0])
        self.starts = [s for s, _, _ in events]
        self.events = events
        self.jobs = sorted(jobs)
        self.job_starts = [s for s, _ in self.jobs]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        for _, e, name in reversed(
                self.events[max(0, i - self.LOOKBACK):i]):
            if e >= t:
                return name
        j = bisect.bisect_right(self.job_starts, t) - 1
        return "host outside torch ops, in a job" if j >= 0 and \
            self.jobs[j][1] >= t else "host between jobs"


class Trace:
    """The window's device intervals and host events."""

    def __init__(self, events: list):
        self.device = []  # (name, cat, start_us, end_us)
        host, jobs = [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((ev.get("name", ""), cat, start, end))
            elif cat == "user_annotation" and ev.get("name") == JOB:
                jobs.append((start, end))
            elif cat in HOST_CATS:
                host.append((start, end, ev.get("name", "")))
        self.lo = min((s for s, _ in jobs), default=0.0)
        self.hi = max((e for _, e in jobs), default=0.0)
        self.host = HostIndex(host, jobs)
        self.device = [d for d in self.device if d[3] > self.lo
                       and d[2] < self.hi]

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, _, s, e in self.device],
                            self.lo, self.hi) / 1e6

    def seconds(self, keep) -> float:
        """Summed seconds inside the window of the device intervals for
        which keep(name, cat) holds."""
        return sum(e - s for name, cat, s, e in
                   ((n, c, max(s, self.lo), min(e, self.hi))
                    for n, c, s, e in self.device) if keep(name, cat)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing, each as [name, seconds]."""
        ops = defaultdict(float)
        for name, _, s, e in self.device:
            ops[name[:120]] += (min(e, self.hi) - max(s, self.lo)) / 1e6
        idle = defaultdict(float)
        for s, e in gaps([(s, e) for _, _, s, e in self.device],
                         self.lo, self.hi):
            idle[self.host.at((s + e) / 2)[:120]] += (e - s) / 1e6
        rank = lambda d: [[k, v] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def profiled(fn, workdir: str):
    """Run fn() under torch.profiler with CPU and CUDA activity; returns
    (fn's result, Trace).  The chrome trace goes to `workdir` and is
    deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = fn()
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return result, Trace.from_file(path)
    finally:
        os.remove(path)
