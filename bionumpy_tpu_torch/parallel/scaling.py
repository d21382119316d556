"""Scaling-efficiency proxy over a mesh (the port of
bionumpy_tpu/parallel/scaling.py).

Fixed total work, swept over mesh sizes, with the per-shard compute and
the cross-shard merge timed separately (the same step with and without
its collectives).  On a mesh that repeats one device the shards run one
after another on it, so the sweep measures the cost of the split and
the merge, not a speed-up; across cards the collective term is bounded
by the gathered table bytes, which each record reports, so the
efficiency at N devices can be projected:

    efficiency(N) ~ t_local(work/N) / (t_local(work/N) + t_collective(N))

Run: python -m bionumpy_tpu_torch.parallel.scaling  (the CUDA cards), or
see tests/test_torch_parallel.py (a CPU mesh).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

# conservative peer-link rate for the projection: below a PCIe 5.0 x16
# link's 64 GB/s per direction (NVLink between H100s is faster)
LINK_BYTES_PER_S = 50e9


def _sharded_local_only(mesh, k: int, cap: int):
    """The sparse-count step WITHOUT the cross-shard merge: per-shard
    compacted tables stay on their devices."""
    from .sparse_parallel import _local_table

    def step(words, ends, n_true):
        return [_local_table(w, e, n, k, cap)
                for w, e, n in zip(words, ends, n_true)]

    return step


def _synchronize(mesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def measure(n_devices_list=(1, 2, 4, 8), n_bases: int = 1 << 20,
            k: int = 31, cap: int = 1 << 13, iters: int = 2,
            devices=None) -> list:
    """Fixed-total-work sweep; returns one record per mesh size with the
    local-compute and with-collective wall times.  `devices` as in
    create_mesh (None: the CUDA cards); sizes above their number are
    skipped."""
    from .mesh import create_mesh, device_count, put_sharded
    from .sparse_parallel import shard_packed_reads, \
        sharded_sparse_count_step

    n_available = device_count() if devices is None else len(devices)
    rng = np.random.default_rng(5)
    read_len = 150
    n_reads = n_bases // read_len
    lengths = np.full(n_reads, read_len)
    flat = rng.integers(0, 4, lengths.sum()).astype(np.uint8)

    records = []
    for n_dev in n_devices_list:
        if n_dev > n_available:
            continue
        mesh = create_mesh(n_dev, devices=devices)
        words, ends, n_true = shard_packed_reads(flat, lengths, n_dev)
        w = put_sharded(mesh, words.view(np.int32))
        e = put_sharded(mesh, ends)
        nt = [int(n) for n in n_true]

        local = _sharded_local_only(mesh, k, cap)
        full = sharded_sparse_count_step(mesh, k, cap)

        def timed(fn):
            fn(w, e, nt)
            _synchronize(mesh)
            ts = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn(w, e, nt)
                _synchronize(mesh)
                ts.append(time.perf_counter() - t0)
            return min(ts)

        t_local = timed(local)
        t_full = timed(full)
        records.append({
            "n_devices": n_dev,
            "t_local_s": round(t_local, 4),
            "t_with_collectives_s": round(t_full, 4),
            "collective_overhead_s": round(max(t_full - t_local, 0), 4),
            # int64 key + int64 count per table row
            "bytes_gathered": int(2 * 8 * cap * n_dev),
        })
    if records:
        base = records[0]["t_local_s"] or 1e-9
        n_cores = os.cpu_count() or 1
        for r in records:
            n = r["n_devices"]
            r["host_cpu_count"] = n_cores
            r["local_speedup_vs_1dev"] = round(base / max(
                r["t_local_s"], 1e-9), 2)
            r["efficiency_proxy"] = round(
                base / max(r["t_with_collectives_s"], 1e-9) / n, 3)
            # with one device per shard the local term scales by
            # construction (shards are independent); the link adds the
            # measured-bytes gather
            t_shard = base / n
            r["projected_ici_efficiency"] = round(
                t_shard / (t_shard + r["bytes_gathered"] / LINK_BYTES_PER_S),
                3)
            r["note"] = (
                "efficiency_proxy is measured on this mesh's devices (a "
                "repeated device runs its shards one after another); "
                "projected_ici_efficiency assumes one device per shard and "
                "the gathered bytes over a conservative 50 GB/s peer link")
    return records


if __name__ == "__main__":
    for rec in measure():
        print(json.dumps(rec))
