"""Run one cell of the benchmark of bionumpy_tpu_torch once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port.  Makes the cell's
inputs from the seed, builds or loads the port's libraries, warms up,
runs jobs in a closed loop for `--seconds`, holds their outputs to the
plain reference, and prints one JSON line last on standard output:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}, with the end-to-end metrics of BENCHMARK.json without a trace
and the per-layer ones with `--trace 1`.  The numbers compared are also
the last lines of standard error, each beside its limit.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), when the port is missing, and when JAX or the
JAX package was loaded in this process.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".benchcache")
# caches at fixed paths inside the checkout, so that only a checkout's
# first run builds, and the two sides of a comparison share nothing
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "bionumpy_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def gpu_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench.harness import run_cell
    from portbench.registry import Registry

    registry = Registry()
    chips = registry.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {gpu_line()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    result = run_cell(registry, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T0, log)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process, and must not be: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
