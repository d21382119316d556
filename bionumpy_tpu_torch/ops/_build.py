"""Build the port's native libraries at first use.

Every library is compiled from the sources in the package's `csrc/` into
`bionumpy_tpu_torch/_build/` (listed in .gitignore) and rebuilt when a
source is newer than it.  CUDA sources go through `nvcc` into a shared
library with a plain C interface, loaded with ctypes: no PyTorch headers,
so a build takes seconds.  A build writes a temporary file and renames
it, so concurrent processes never load a half-written library.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
# what kmers.cu and pwm.cu include: the packed stream's spans and grid
SPAN_HEADER = os.path.join(CSRC, "packed_span.cuh")

HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# compiler output of the last build of each library (ptxas register and
# spill report for the CUDA kernels); empty when the library was current
LOGS: dict = {}

# one lock per library: two libraries build at once, one never twice
_locks: dict = {}
_locks_lock = threading.Lock()


def build(name: str, sources: list, compiler: list,
          headers: tuple = ()) -> str:
    """Path of `_build/lib<name>.so`, compiled from `sources` with the
    `compiler` command unless it is newer than every source and every
    header they include.  Raises RuntimeError with the compiler's output
    when the build fails."""
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if os.path.exists(out) and all(
                os.path.getmtime(s) <= os.path.getmtime(out)
                for s in [*sources, *headers]):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(compiler + ["-o", tmp] + sources,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        LOGS[name] = proc.stdout + proc.stderr
    return out


def nvcc() -> str:
    """The CUDA compiler: `nvcc` on PATH, else the one of the toolkit at
    $CUDA_HOME (default /usr/local/cuda).  Raises when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path
