"""The device table's hand-written CUDA kernel (csrc/tables.cu): the
merge of sorted sentinel tables, its wrapper, launch count and plain
PyTorch version.

The wrapper takes tensors on the CPU to the plain version and, for CUDA
tensors, launches the kernel or raises: there is no fallback.  The
library is built with nvcc at the first merge on the card
(ops/_build.py), so calls that never fold a table never build it, and is
bound with ctypes; importing this module needs no compiler and no card.

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
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import _build
from .kmer_kernels import SENTINEL

_SOURCE = os.path.join(_build.CSRC, "tables.cu")

# launches per kernel since the last reset_launches(): one a merge of two
# tables (the six kernels of csrc/tables.cu), counted where it launches
LAUNCHES = {"merge_tables_kernel": 0}

_lib = None

__all__ = ["SENTINEL", "LAUNCHES", "reset_launches", "build",
           "merge_tables_plain", "merge_tables"]


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
