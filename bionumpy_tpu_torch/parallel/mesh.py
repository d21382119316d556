"""A single-process device mesh and its collectives (the port of
bionumpy_tpu/parallel/mesh.py and of the JAX collectives the mesh steps
use).

The JAX package shards a batch over a 1-D "dp" jax.sharding.Mesh from
one Python process: it reads the file once, puts one shard on each
device and gets one merged table back.  The port keeps that API with a
Mesh over a tuple of torch devices, driven from one process: a step
runs each shard's ops on the shard's device (each device's current
stream), and a collective moves the shards' partials to the lead device
(the first) and merges them there.  No torch.distributed and no NCCL:
with several cards a move is a peer copy, with one device repeated it
is no copy at all, which is how the mesh runs eight shards on the CPU
and four on one card.

A stacked (n_dev, ...) host array becomes one tensor per device with
put_sharded (JAX's device_put under P("dp", ...)) and one copy per
device with put_replicated (P()).  A step returns a replicated output as
one tensor on the lead device and a sharded output as a list of
per-shard tensors, one on each device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "create_mesh", "device_count", "all_gather", "psum",
           "pmax", "ppermute", "put_sharded", "put_replicated"]


class Mesh:
    """A 1-D data-parallel mesh over torch devices, repeats allowed.
    `devices` is a numpy object array (so `mesh.devices.size` counts the
    shards, as JAX code reads it); the first device is the lead."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = ("dp",)):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len(tuple(axis_names)) != 1:
            raise ValueError(f"the mesh is 1-D: one axis name, got "
                             f"{tuple(axis_names)}")
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = devices
        self.axis_names = tuple(axis_names)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def device_count() -> int:
    return torch.cuda.device_count()


def create_mesh(n_devices: Optional[int] = None,
                axis_names: Sequence[str] = ("dp",),
                devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over the first `n_devices` CUDA cards (all
    of them when None), or over the first `n_devices` of the explicit
    `devices` list, which may repeat a device.  Raises ValueError when
    fewer devices are there than asked for."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(device_count())]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"a mesh of {n_devices} devices needs that many; "
                         f"{len(devices)} available")
    return Mesh(devices[:n_devices], axis_names)


def all_gather(mesh: Mesh, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards concatenated in shard order on the lead device (JAX's
    all_gather(...).reshape(-1), kept once instead of on every shard)."""
    return torch.cat([t.to(mesh.lead, non_blocking=True) for t in shards])


def psum(mesh: Mesh, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The element-wise sum of the shards, in shard order, on the lead
    device."""
    out = shards[0].to(mesh.lead, non_blocking=True)
    for t in shards[1:]:
        out = out + t.to(mesh.lead, non_blocking=True)
    return out


def pmax(mesh: Mesh, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The element-wise maximum of the shards on the lead device."""
    out = shards[0].to(mesh.lead, non_blocking=True)
    for t in shards[1:]:
        out = torch.maximum(out, t.to(mesh.lead, non_blocking=True))
    return out


def ppermute(mesh: Mesh, shards: Sequence[torch.Tensor],
             perm: Sequence) -> list:
    """JAX's ppermute: for each (source, destination) pair of `perm`,
    shard `destination` receives shard `source`'s tensor on its own
    device; a shard that is no destination receives zeros."""
    out = [torch.zeros_like(t) for t in shards]
    for src, dst in perm:
        out[dst] = shards[src].to(mesh.devices[dst], non_blocking=True)
    return out


def put_sharded(mesh: Mesh, array) -> list:
    """One tensor per device from a stacked (n_dev, ...) host array: row i
    goes to device i."""
    array = np.asarray(array)
    if array.shape[0] != mesh.devices.size:
        raise ValueError(f"{array.shape[0]} shards for a mesh of "
                         f"{mesh.devices.size} devices")
    return [torch.from_numpy(np.ascontiguousarray(array[i])).to(
        dev, non_blocking=True) for i, dev in enumerate(mesh.devices)]


def put_replicated(mesh: Mesh, array) -> list:
    """The same host array on every device of the mesh: one copy per
    distinct device, shared by the shards that repeat it."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = host.to(dev, non_blocking=True)
    return [copies[dev] for dev in mesh.devices]
