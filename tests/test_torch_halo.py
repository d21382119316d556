"""The port's halo exchange over one long sharded sequence
(bionumpy_tpu_torch/parallel/halo.py) against the JAX package's: JAX on
the 8 virtual CPU devices of tests/conftest.py, the port on a mesh that
repeats the CPU 8 times (kernel 1's plain version).  Keys at valid
positions and the validity masks are array-equal, to JAX's and to the
unsharded computation."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bionumpy_tpu.parallel import create_mesh as jcreate_mesh
from bionumpy_tpu.parallel import halo as jhalo
from bionumpy_tpu_torch.parallel import create_mesh, halo
from bionumpy_tpu_torch.parallel.mesh import put_sharded

N_DEV = 8


@pytest.fixture(scope="module")
def meshes():
    if jax.device_count() < N_DEV:
        pytest.skip("needs 8 (virtual) devices")
    return jcreate_mesh(N_DEV), create_mesh(
        N_DEV, devices=[torch.device("cpu")] * N_DEV)


@pytest.fixture(scope="module")
def genome_codes():
    rng = np.random.default_rng(101)
    return rng.integers(0, 4, 100_003).astype(np.uint8)


def _host_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    vals = np.zeros(len(codes), dtype=np.uint64)
    c = codes.astype(np.uint64)
    for j in range(k):
        vals[: len(codes) - j] |= c[j:] << np.uint64(2 * j)
    return vals


def _flat(out):
    return [torch.cat(parts).numpy() for parts in out]


def _keys(lo, hi):
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))


def _jax_run(jmesh, step, blocks, n):
    b = jax.device_put(jnp.asarray(blocks), NamedSharding(jmesh, P("dp", None)))
    return [np.asarray(x).reshape(-1) for x in step(b, jnp.int64(n))]


@pytest.mark.parametrize("k", [31, 12])
def test_sharded_kmer_hash_equals_jax_and_single(meshes, genome_codes, k):
    """Windows crossing shard edges hash over the neighbour's bases: the
    keys at valid positions equal JAX's lo | hi << 32 and the unsharded
    hashes, and the validity equals JAX's."""
    jmesh, mesh = meshes
    blocks, n = halo.shard_long_sequence(genome_codes, N_DEV)
    jblocks, jn = jhalo.shard_long_sequence(genome_codes, N_DEV)
    np.testing.assert_array_equal(blocks, jblocks)
    assert n == jn
    lo, hi, valid = _flat(halo.sharded_kmer_hash_step(mesh, k)(
        put_sharded(mesh, blocks), n))
    jlo, jhi, jvalid = _jax_run(jmesh, jhalo.sharded_kmer_hash_step(jmesh, k),
                                blocks, n)
    np.testing.assert_array_equal(valid, jvalid)
    exp_valid = np.zeros(blocks.size, bool)
    exp_valid[: n - k + 1] = True
    np.testing.assert_array_equal(valid, exp_valid)
    got = _keys(lo, hi)[valid]
    np.testing.assert_array_equal(got, _keys(jlo, jhi)[valid])
    np.testing.assert_array_equal(got, _host_hashes(genome_codes, k)[
        exp_valid[:n]])


@pytest.mark.parametrize("k,w", [(21, 30), (15, 40)])
def test_sharded_minimizers_equal_jax_and_single(meshes, genome_codes, k, w):
    jmesh, mesh = meshes
    from bionumpy_tpu_torch.ops.device import distance_to_row_end
    from bionumpy_tpu_torch.ops.minimizers import minimizer_limbs
    blocks, n = halo.shard_long_sequence(genome_codes, N_DEV)
    lo, hi, valid = _flat(halo.sharded_minimizer_step(mesh, k, w)(
        put_sharded(mesh, blocks), n))
    jlo, jhi, jvalid = _jax_run(
        jmesh, jhalo.sharded_minimizer_step(jmesh, k, w), blocks, n)
    np.testing.assert_array_equal(valid, jvalid)
    nv = n - w + 1
    assert valid[:nv].all() and not valid[nv:].any()
    np.testing.assert_array_equal(_keys(lo, hi)[:nv], _keys(jlo, jhi)[:nv])
    # the port's single-device twin on the whole sequence
    pad = (-len(genome_codes)) % 16
    codes = np.concatenate([genome_codes, np.zeros(pad + 32, np.uint8)])
    dist = np.zeros(len(codes) - 32, np.int32)
    dist[:n] = distance_to_row_end(np.array([n]))
    s_lo, s_hi, s_valid = [t.numpy() for t in minimizer_limbs(
        torch.from_numpy(codes), torch.from_numpy(dist), k, w - k + 1)]
    assert s_valid[:nv].all()
    np.testing.assert_array_equal(lo[:nv], s_lo[:nv])
    np.testing.assert_array_equal(hi[:nv], s_hi[:nv])


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shard_counts_agree(genome_codes, n_shards):
    """Any shard count gives the one-shard keys at the valid positions."""
    cpu = [torch.device("cpu")] * n_shards
    one = create_mesh(1, devices=cpu)
    mesh = create_mesh(n_shards, devices=cpu)
    codes = genome_codes[:20_011]
    out = []
    for m in (one, mesh):
        blocks, n = halo.shard_long_sequence(codes, m.devices.size)
        lo, hi, valid = _flat(halo.sharded_kmer_hash_step(m, 31)(
            put_sharded(m, blocks), n))
        out.append(_keys(lo, hi)[valid])
    np.testing.assert_array_equal(out[0], out[1])


def test_halo_guard_rejects_tiny_shards():
    """Shards shorter than the halo are rejected instead of hashing over
    missing data, in the host split and in the step."""
    codes = np.zeros(64, np.uint8)  # 8 bases/shard on 8 shards
    for shard in (halo.shard_long_sequence, jhalo.shard_long_sequence):
        with pytest.raises(ValueError, match="halo"):
            shard(codes, 8, window_size=31)
    mesh = create_mesh(8, devices=[torch.device("cpu")] * 8)
    blocks, n = halo.shard_long_sequence(codes[:63], 4)
    mesh4 = create_mesh(4, devices=[torch.device("cpu")] * 4)
    with pytest.raises(ValueError, match="halo"):
        halo.sharded_minimizer_step(mesh4, 21, 40)(
            put_sharded(mesh4, blocks), n)
    with pytest.raises(ValueError, match="window_size"):
        halo.sharded_minimizer_step(mesh, 21, 20)
