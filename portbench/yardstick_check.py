"""A check of the yardstick's time source: the profiler's device time of
kmer_keys_kernel against CUDA events recorded around the same launches.

    python3 portbench/yardstick_check.py --workload minimizer21-genome \
        --seed 5 --jobs 30

Runs the cell's jobs (after its warm-up) under torch.profiler, with the
port's kmer_keys wrapped so that a CUDA event is recorded on the
launching stream just before and just after each launch, and prints
both sums and their ratio as one JSON line, in two passes.  In the
first the stream is idle when the start event is recorded, so the pair
also holds the host's time to reach the launch.  In the second a spin
kernel (torch.cuda._sleep) is queued before the start event, so the
kernel is queued before the stream reaches the event and the pair holds
the kernel alone.  Needs the card.
"""
import argparse
import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import traffic  # noqa: E402
from portbench.harness import Context  # noqa: E402
from portbench.registry import HERE, Registry  # noqa: E402
from portbench.trace import profiled  # noqa: E402

KERNEL = re.compile(r"\bkmer_keys_kernel\b")
SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's 1.98 GHz


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="minimizer21-genome")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from bionumpy_tpu_torch.ops import kmer_kernels, kmers, minimizers

    ctx = Context(Registry([HERE]), args.workload, "cuda")
    entry = ctx.registry.entry(ctx.cell["entry"])
    pairs = []
    spin = [0]
    plain = kmer_kernels.kmer_keys

    def timed_keys(*a, **kw):
        if spin[0]:
            torch.cuda._sleep(spin[0])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        keys = plain(*a, **kw)
        end.record()
        pairs.append((start, end))
        return keys

    with tempfile.TemporaryDirectory() as workdir:
        inputs = traffic.make_inputs(ctx.cell, ctx.config, args.seed,
                                     workdir)
        objs = entry.prepare(ctx, inputs)
        for index in range(len(inputs)):
            entry.call(ctx, objs[index], inputs[index])
        torch.cuda.synchronize()
        minimizers.kmer_keys = kmers.kmer_keys = timed_keys
        try:
            def jobs():
                for i in range(args.jobs):
                    with torch.profiler.record_function("portbench.job"):
                        entry.call(ctx, objs[i % len(objs)],
                                   inputs[i % len(inputs)])
                        torch.cuda.synchronize()

            for cycles in (0, SPIN_CYCLES):
                spin[0] = cycles
                pairs.clear()
                t0 = time.perf_counter()
                _, trace = profiled(jobs, workdir)
                wall = time.perf_counter() - t0
                events_ms = sum(s.elapsed_time(e) for s, e in pairs)
                launches = [e for e in trace.device if KERNEL.search(e[0])]
                profiler_ms = sum(e[3] - e[2] for e in launches) / 1e3
                print(json.dumps({
                    "workload": args.workload, "seed": args.seed,
                    "jobs": args.jobs, "spin_cycles": cycles,
                    "wall_s": wall, "launches_wrapped": len(pairs),
                    "launches_traced": len(launches),
                    "events_ms": events_ms, "profiler_ms": profiler_ms,
                    "events_over_profiler": events_ms / profiler_ms
                    if profiler_ms else None,
                    "card": torch.cuda.get_device_name()}), flush=True)
        finally:
            minimizers.kmer_keys = kmers.kmer_keys = plain
    return 0


if __name__ == "__main__":
    sys.exit(main())
