"""The device table's hand-written CUDA kernels (csrc/tables.cu): the
merge of sorted sentinel tables and the run table of sorted keys, their
wrappers, launch counts and plain PyTorch versions.

Each wrapper takes tensors on the CPU to the plain version and, for CUDA
tensors, launches the kernel or raises: there is no fallback.  The
library is built with nvcc at the first table on the card
(ops/_build.py), so calls that never make a table on the card never
build it, and is bound with ctypes; importing this module needs no
compiler and no card.

merge_tables_kernel -- replaces no Pallas kernel: the JAX package folds
    tables by XLA's sort of their concatenation (merge_hash_tables in
    bionumpy_tpu/ops/kmers.py, from pipeline._fold_program_impl), as the
    port's fold did until the merge.  A sentinel table is (keys, counts)
    int64 rows, the live keys sorted and unique, then (SENTINEL, 0)
    padding: what ops/kmers.sentinel_table makes and fold_tables holds.
    Two such tables merge into min(cap, rows in) rows, each distinct live
    key once with its counts added, without a sort: live lengths by
    binary search, a merge-path partition into tiles of 2048 merged rows,
    a count pass, a scan of the tiles' counts, a write pass and the
    padding's fill (six launches, one `launch` here).  Bound by bytes:
    the inputs' live rows read once and the output written once, 16 bytes
    a row, at most 21.5 GB (6.4 ms at 3.35 TB/s) for a 2^29-row
    accumulator and a 2^28-row pass table.  More than two tables merge
    two at a time, each result cut to `cap` rows, which keeps the
    smallest keys whole.

run_table_kernel -- replaces no Pallas kernel: the JAX package compacts
    a sorted key array's runs in XLA (run marks, a stable sort of
    (~is_head, position), differences of the run starts), as the port
    did in ~20 torch ops a table (sort_runs' marks, compact_runs,
    counts_from_runs and a `where`), which stay as the plain version.
    The sorted keys of a table (every sentinel last) become its first
    `rows` runs below the first sentinel, each as (key, length), then
    (SENTINEL, 0) rows, and the meta [n_unique, n_valid]: a binary search
    for the live length, a count pass of the heads a tile of 2048 keys, a
    one-block scan (output offsets, and the first head past each tile,
    which closes a run that crosses tiles), a write pass and the fill
    (five launches, one `launch` here).  Bound by bytes: the live keys
    read once and `rows` rows of 16 bytes written once, 6.3 GB (1.9 ms)
    for a pass of 2^28 keys.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..instrument import add
from . import _build
from .kmer_kernels import SENTINEL

_SOURCE = os.path.join(_build.CSRC, "tables.cu")

# launches per kernel since the last reset_launches(), counted where they
# launch: one a merge of two tables (six kernels of csrc/tables.cu), one a
# table compacted from its sorted keys (five kernels)
LAUNCHES = {"merge_tables_kernel": 0, "run_table_kernel": 0}

_lib = None

__all__ = ["SENTINEL", "LAUNCHES", "reset_launches", "build",
           "merge_tables_plain", "merge_tables", "run_table_plain",
           "run_table"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> ctypes.CDLL:
    """The kernel's library, compiled (if stale) and loaded once."""
    global _lib
    if _lib is None:
        path = _build.build("tables", [_SOURCE],
                            [_build.nvcc()] + _build.NVCC_FLAGS)
        lib = ctypes.CDLL(path)
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.merge_tables_scratch.restype = ll
        lib.merge_tables_scratch.argtypes = [ll]
        lib.merge_tables_launch.restype = ctypes.c_int
        lib.merge_tables_launch.argtypes = [vp, vp, ll, vp, vp, ll, ll, vp,
                                            vp, ll, vp, vp, vp]
        lib.run_table_scratch.restype = ll
        lib.run_table_scratch.argtypes = [ll]
        lib.run_table_launch.restype = ctypes.c_int
        lib.run_table_launch.argtypes = [vp, ll, ll, vp, vp, vp, vp, vp]
        _lib = lib
    return _lib


def _check_tables(tables) -> torch.device:
    """The device of the tables; raises ValueError unless every key and
    count tensor is a contiguous 1-D int64 tensor on it, a table's two of
    one length."""
    if not tables:
        raise ValueError("no tables to merge")
    device = tables[0][0].device
    for keys, counts in tables:
        for t in (keys, counts):
            if t.dtype != torch.int64 or t.dim() != 1 or \
                    not t.is_contiguous() or t.device != device:
                raise ValueError("a table is a pair of contiguous 1-D int64 "
                                 "tensors, all on one device")
        if keys.numel() != counts.numel():
            raise ValueError("a table's keys and counts differ in length")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device


def merge_tables_plain(tables, cap: int):
    """Plain PyTorch version of merge_tables: merge_hash_tables over the
    concatenated tables (it sorts; past `cap` distinct keys it cuts the
    last total, as the JAX package does)."""
    from .kmers import merge_hash_tables
    return merge_hash_tables(torch.cat([k for k, _ in tables]),
                             torch.cat([c for _, c in tables]), cap)


def _merge_two(a, b, cap: int, lib):
    rows_in = a[0].numel() + b[0].numel()
    out_rows = min(cap, rows_in)
    device = a[0].device
    keys = torch.empty(out_rows, dtype=torch.int64, device=device)
    counts = torch.empty(out_rows, dtype=torch.int64, device=device)
    n_unique = torch.empty((), dtype=torch.int64, device=device)
    scratch = torch.empty(lib.merge_tables_scratch(rows_in),
                          dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.merge_tables_launch(
            a[0].data_ptr(), a[1].data_ptr(), a[0].numel(), b[0].data_ptr(),
            b[1].data_ptr(), b[0].numel(), cap, keys.data_ptr(),
            counts.data_ptr(), out_rows, n_unique.data_ptr(),
            scratch.data_ptr(), stream)
    if err:
        raise RuntimeError(f"merge_tables_kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["merge_tables_kernel"] += 1
    return keys, counts, n_unique


def merge_tables(tables, cap: int):
    """One sentinel table of `tables`, a sequence of (keys, counts) int64
    sentinel tables (live keys sorted and unique, then (SENTINEL, 0)
    rows), with no wait: (keys, counts, n_unique) as
    merge_hash_tables(cat(keys), cat(counts), cap) returns them.  The
    result has min(cap, rows in) rows, its live keys sorted and unique
    with their summed counts, the rest (SENTINEL, 0); n_unique is a
    device scalar, the distinct live keys clamped at `cap`.  Past `cap`
    distinct keys the kernel keeps the first `cap` with whole totals,
    where the plain version cuts the last."""
    device = _check_tables(tables)
    if device.type == "cpu":
        return merge_tables_plain(tables, cap)
    lib = build()
    acc, *rest = tables
    if not rest:
        rest = [(acc[0].new_empty(0), acc[1].new_empty(0))]
    for table in rest:
        acc = _merge_two(acc[:2], table, cap, lib)
    return acc


def run_table_plain(sorted_keys: torch.Tensor, rows: int):
    """Plain PyTorch version of run_table: the run marks of sort_runs,
    compact_runs and counts_from_runs at `rows`, the rows past n_unique
    set to (SENTINEL, 0)."""
    from .kmers import compact_runs, counts_from_runs, run_marks
    is_start, n_unique, n_valid = run_marks(sorted_keys)
    uniq, run_starts = compact_runs(sorted_keys, is_start, rows)
    counts = counts_from_runs(run_starts, n_unique, n_valid, rows)
    live = torch.arange(rows, device=sorted_keys.device) < n_unique
    return (torch.where(live, uniq, SENTINEL), counts,
            torch.stack([n_unique, n_valid]))


def run_table(sorted_keys: torch.Tensor, rows: int):
    """The sentinel table of `sorted_keys`, a contiguous 1-D int64 tensor
    sorted ascending (so every SENTINEL last), with no wait: (keys,
    counts, meta).  keys and counts have `rows` rows (at most the keys'
    length): the first `rows` runs of equal keys below the first
    SENTINEL, each as its key and its length, then (SENTINEL, 0) rows;
    meta is the (2,) int64 device tensor [n_unique, n_valid], the runs
    (not clamped at `rows`) and the keys below the first SENTINEL.  Past
    `rows` runs the last row's count is 0 less its run's start, as the
    JAX package cuts its table.  Counted once as `run-table` (rows: the
    sorted keys)."""
    t = sorted_keys
    if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError("run_table takes a contiguous 1-D int64 tensor of "
                         "sorted keys")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    n, rows = t.numel(), int(rows)
    if not 0 <= rows <= n:
        raise ValueError(f"rows {rows} outside 0..{n}, the keys' length")
    add("run-table", 0.0, rows=n)
    if t.device.type == "cpu":
        return run_table_plain(t, rows)
    lib = build()
    keys = torch.empty(rows, dtype=torch.int64, device=t.device)
    counts = torch.empty(rows, dtype=torch.int64, device=t.device)
    meta = torch.empty(2, dtype=torch.int64, device=t.device)
    scratch = torch.empty(lib.run_table_scratch(n), dtype=torch.int64,
                          device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.run_table_launch(t.data_ptr(), n, rows, keys.data_ptr(),
                                   counts.data_ptr(), meta.data_ptr(),
                                   scratch.data_ptr(), stream)
    if err:
        raise RuntimeError(f"run_table_kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["run_table_kernel"] += 1
    return keys, counts, meta
