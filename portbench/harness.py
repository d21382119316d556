"""One run of one cell: inputs from the seed, warm-up, a closed loop of
jobs for the window, the reference and the comparison, the metrics.

The loop models one user running one analysis after another: a job
starts when the last one returns.  Each job's table is summarised
(rows, total count) as it returns, and a seeded sample of whole outputs,
one or more per input, is kept for the reference, which runs once the
window has closed, the peak memory has been read and the program's
state is freed.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.profiler

from portbench import reference as R
from portbench import traffic
from portbench.registry import Registry

KEPT_PER_INPUT = 2   # whole outputs kept per input for the reference
SAMPLE_STREAM = 99   # the seed's stream for that sample
MAX_TRACEBACKS = 3   # failed jobs whose traceback goes to stderr


class Job:
    __slots__ = ("start", "end", "n_bases", "n_reads", "ok", "digest",
                 "input")

    def __init__(self, start, end, inp, index, ok, digest):
        self.start, self.end, self.ok, self.digest = start, end, ok, digest
        self.n_bases, self.n_reads, self.input = inp.n_bases, inp.n_reads, \
            index


class Context:
    """What a run knows, handed to entries and metric readers."""

    def __init__(self, registry, cell_name, device):
        self.registry = registry
        self.cell = registry.cell(cell_name)
        self.config = registry.config(self.cell["config"])
        self.device = device
        self.setup_s = None
        self.jobs = []
        self.window_s = 0.0
        self.stages = {}
        self.trace = None
        self.peaks = {}

    @property
    def gbases(self) -> float:
        return sum(j.n_bases for j in self.jobs if j.ok) / 1e9


class Reservoir:
    """A seeded uniform sample of up to `size` outputs per input."""

    def __init__(self, seed: int, size: int):
        self.rng = traffic.rng_for(seed, SAMPLE_STREAM)
        self.size = size
        self.seen = {}
        self.kept = {}

    def offer(self, index: int, out) -> None:
        n = self.seen[index] = self.seen.get(index, 0) + 1
        kept = self.kept.setdefault(index, [])
        if len(kept) < self.size:
            kept.append(out)
        else:
            slot = int(self.rng.integers(0, n))
            if slot < self.size:
                kept[slot] = out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def closed_loop(ctx, entry, objs, inputs, seconds, reservoir, log):
    """Jobs one after another, each on the next input in turn, until
    `seconds` have passed since the first started; returns the jobs."""
    jobs, n_failed = [], 0
    start = time.perf_counter()
    i = 0
    while not jobs or time.perf_counter() - start < seconds:
        index = i % len(inputs)
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.job"):
            try:
                out = entry.call(ctx, objs[index], inputs[index])
                sync(ctx.device)
                ok = True
            except Exception:  # a failed job counts, the loop goes on
                out, ok = None, False
                n_failed += 1
                if n_failed <= MAX_TRACEBACKS:
                    log(f"job {i} failed:\n{traceback.format_exc()}")
        end = time.perf_counter()
        jobs.append(Job(t0, end, inputs[index], index, ok,
                        R.digest(out) if ok else None))
        if ok:
            reservoir.offer(index, out)
        del out
        i += 1
    return jobs


def check(ctx, entry, inputs, reservoir, device, log) -> dict:
    """Hold the kept outputs and every job's digest to the reference,
    worked out from the generated inputs; returns {name: value} of the
    numbers compared, summed over what was compared."""
    numbers = {name: 0 for name in entry.LIMITS}
    for index in sorted(reservoir.kept):
        t0 = time.perf_counter()
        ref = entry.reference(ctx, inputs[index], device)
        want = R.digest(ref)
        numbers["digests_differing"] += sum(
            j.digest != want for j in ctx.jobs if j.ok and j.input == index)
        for out in reservoir.kept[index]:
            for name, value in entry.compare(out, ref, device).items():
                numbers[name] += value
        del ref
        log(f"reference for input {index}: {time.perf_counter() - t0:.3f} s")
    return numbers


def run_cell(registry: Registry, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str, t0: float, log=None) -> dict:
    """One run; returns the result line's dict (its metrics already
    chosen by `trace`).  `t0` is the perf_counter reading at which the
    process started."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    import bionumpy_tpu_torch as bt
    from bionumpy_tpu_torch.ops import kmer_kernels, resident

    ctx = Context(registry, cell_name, device)
    entry = registry.entry(ctx.cell["entry"])
    on_card = torch.device(device).type == "cuda"
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        inputs = traffic.make_inputs(ctx.cell, ctx.config, seed, workdir)
        log(f"inputs: {len(inputs)} x {inputs[0].n_reads} rows, "
            f"{sum(i.n_bases for i in inputs)} bases, made at "
            f"{time.perf_counter() - t0:.3f} s")
        objs = entry.prepare(ctx, inputs)
        for _ in range(ctx.cell.get("warmup_rounds", 1)):
            for index in range(len(inputs)):
                entry.call(ctx, objs[index], inputs[index])
        sync(device)
        ctx.setup_s = time.perf_counter() - t0
        log(f"setup: {ctx.setup_s:.3f} s")

        bt.instrument.reset()
        resident.reset_transfer_counters()
        kmer_kernels.reset_launches()
        reservoir = Reservoir(seed, KEPT_PER_INPUT)

        def window():
            return closed_loop(ctx, entry, objs, inputs, seconds, reservoir,
                               log)

        if trace:
            from portbench.trace import profiled
            ctx.jobs, ctx.trace = profiled(window, workdir)
        else:
            ctx.jobs = window()
        ctx.window_s = ctx.jobs[-1].end - ctx.jobs[0].start
        ctx.stages = bt.instrument.report()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        log(f"window: {len(ctx.jobs)} jobs in {ctx.window_s:.3f} s; "
            f"uploads {resident.TRANSFER_COUNT} "
            f"({resident.TRANSFER_BYTES} bytes); launches "
            f"{dict(kmer_kernels.LAUNCHES)}; stages {ctx.stages}")
        log("job ms: " + " ".join(f"{(j.end - j.start) * 1e3:.1f}"
                                  for j in ctx.jobs))
        del objs
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        numbers = check(ctx, entry, inputs, reservoir, device, log)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    failed = sum(not j.ok for j in ctx.jobs)
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in entry.LIMITS.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        peaks = json.load(f)
    ctx.peaks = peaks["devices"].get(kind) or \
        peaks["devices"][peaks["default"]]
    metrics = {}
    for m in registry.metrics_of(cell_name, trace):
        value = registry.metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(ctx.jobs),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": kind, "count": 1,
                         "memory_peak_bytes": peak}}
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    return result

