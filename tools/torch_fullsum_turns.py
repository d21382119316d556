#!/usr/bin/env python3
"""kmer_fullsum_kernel of two checkouts of bionumpy_tpu_torch, timed in
turns on one NVIDIA GPU with chip_smoke.py's two yardsticks.

    python3 tools/torch_fullsum_turns.py PARENT_DIR CHANGE_DIR [PAIRS]

Runs each checkout in a process of its own, in the order parent,
change, change, parent, PAIRS times (default 1).  Each process imports
the checkout's package, builds its libkmers.so from its sources, and
launches its kmer_fullsum_launch through ctypes on seeded random words:
2^25 positions (one full batch) at k = 31 and k = 15, and one
2^22-position checksum chunk at k = 31.  It holds each launch's sums
against the checkout's plain version (exact), then prints one JSON line
with, per case, `ms` (chip_smoke.median_ms: CUDA events around
back-to-back launches, over their count) and `device_ms`
(chip_smoke.kernel_device_ms: each launch's own duration under the
profiler).  The last line is the card's name and power limit.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7
CASES = {"k31": (31, 1 << 25), "k15": (15, 1 << 25), "chunk": (31, 1 << 22)}


def _yardsticks():
    """chip_smoke.py of this checkout, for its timing functions."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_yardsticks", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_checkout(checkout: str) -> dict:
    import torch
    sys.path.insert(0, os.path.abspath(checkout))
    from bionumpy_tpu_torch.ops import kmer_kernels as kk
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    smoke = _yardsticks()
    lib = kk.build()
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(SEED)
    words = torch.from_numpy(rng.integers(
        0, 2 ** 32, (1 << 25) // 16 + 2, dtype=np.uint64).astype(np.uint32)
        .view(np.int32)).to("cuda")
    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    result = {"checkout": checkout, "package": kk.__file__}
    for case, (k, n_pos) in CASES.items():
        def launch(k=k, n_pos=n_pos):
            lib.kmer_fullsum_launch(words.data_ptr(), n_pos, k,
                                    out.data_ptr(), stream)

        out.zero_()
        launch()
        got = (out.to(torch.int64) & 0xFFFFFFFF).tolist()
        want = kk.kmer_fullsum_plain(words[: n_pos // 16 + 2], k).tolist()
        if got != want:
            raise AssertionError(f"{checkout} {case}: {got} != plain {want}")
        result[case] = {
            "ms": smoke.median_ms(launch),
            "device_ms": smoke.kernel_device_ms(launch,
                                                "kmer_fullsum_kernel")}
    return result


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_checkout(argv[1])), flush=True)
        return 0
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv[:2]
    pairs = int(argv[2]) if len(argv) == 3 else 1
    for _ in range(pairs):
        for checkout in (parent, change, change, parent):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", checkout], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
