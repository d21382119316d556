"""The control of the comparison that decides `correct`: the plain
reference put in the program's place, counting its table under 32-bit
keys (a fingerprint table) instead of the configuration's full hashes.
It has to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

Makes the cell's inputs from each seed at the cell's own size, works
out the reference, the control's table, and the numbers the cell
compares, and prints one JSON line a seed with each number beside its
limit.  On the card when there is one, else on the CPU.  The
benchmark's own runs do not run it.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import reference as R  # noqa: E402
from portbench import traffic  # noqa: E402
from portbench.harness import Context  # noqa: E402
from portbench.registry import HERE, Registry  # noqa: E402


def control_output(ref: dict) -> dict:
    """The control's output: the reference's table under 32-bit keys, the
    rest of the reference unchanged."""
    keys, counts = R.fingerprint_control(ref["keys"], ref["counts"])
    out = {"keys": keys.cpu().numpy().view(np.uint64),
           "counts": counts.cpu().numpy()}
    if "stats" in ref:
        out["stats"] = dict(ref["stats"])
    if "gc_bins" in ref:
        out["gc_bins"] = ref["gc_bins"].cpu().numpy()
    return out


def control_readings(registry, cell: str, seed: int, device: str) -> dict:
    """{name: value} of the numbers the cell compares, summed over its
    inputs, for the control in the program's place."""
    ctx = Context(registry, cell, device)
    entry = registry.entry(ctx.cell["entry"])
    with tempfile.TemporaryDirectory() as workdir:
        inputs = traffic.make_inputs(ctx.cell, ctx.config, seed, workdir,
                                     write_files=False)
    numbers = {name: 0 for name in entry.LIMITS}
    for inp in inputs:
        ref = entry.reference(ctx, inp, device)
        out = control_output(ref)
        numbers["digests_differing"] += R.digest(out) != R.digest(ref)
        for name, value in entry.compare(out, ref, device).items():
            numbers[name] += value
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    registry = Registry([HERE])
    limits = registry.entry(registry.cell(args.workload)["entry"]).LIMITS
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control_readings(registry, args.workload, seed, device)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "device": device,
            "seconds": time.perf_counter() - t0,
            "correct": all(v <= limits[k] for k, v in numbers.items()),
            "checks": {k: {"value": v, "limit": limits[k]}
                       for k, v in numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
