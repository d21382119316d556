"""The port's mesh steps (bionumpy_tpu_torch/parallel/) against the JAX
package's on the same seeded inputs: JAX on the 8 virtual CPU devices of
tests/conftest.py, the port on a mesh that repeats the CPU 8 times.
Integer tables, counts and pileups are array-equal; the float32 sum of
sum-and-n agrees within rtol=1e-5 with n exact (the shards' sums are
added in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bionumpy_tpu import parallel as jpar
from bionumpy_tpu_torch import parallel as tpar
from bionumpy_tpu_torch.parallel import mesh as tmesh

N_DEV = 8
CPU8 = [torch.device("cpu")] * N_DEV


@pytest.fixture(scope="module")
def meshes():
    if jax.device_count() < N_DEV:
        pytest.skip("needs 8 (virtual) devices")
    return jpar.create_mesh(N_DEV), tpar.create_mesh(N_DEV, devices=CPU8)


def _jput(mesh, a, spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))


def _keys(lo, hi):
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))


def _packed(seed, n_reads, lo, hi):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi, n_reads)
    return rng.integers(0, 4, lengths.sum()).astype(np.uint8), lengths


def test_mesh_shape_and_errors():
    mesh = tpar.create_mesh(3, devices=CPU8)
    assert mesh.devices.size == 3 and mesh.axis_names == ("dp",)
    assert mesh.lead == torch.device("cpu")
    with pytest.raises(ValueError, match="needs that many"):
        tpar.create_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="0 available"):
            tpar.create_mesh(1)
    assert tpar.device_count() == torch.cuda.device_count()
    with pytest.raises(ValueError, match="shards for a mesh"):
        tmesh.put_sharded(mesh, np.zeros((2, 4)))


def test_collectives():
    mesh = tpar.create_mesh(4, devices=CPU8)
    shards = [torch.arange(3) + 10 * i for i in range(4)]
    assert tmesh.all_gather(mesh, shards).tolist() == \
        [0, 1, 2, 10, 11, 12, 20, 21, 22, 30, 31, 32]
    assert tmesh.psum(mesh, shards).tolist() == [60, 64, 68]
    assert tmesh.pmax(mesh, shards).tolist() == [30, 31, 32]
    got = tmesh.ppermute(mesh, shards, [((i + 1) % 4, i) for i in range(4)])
    assert [t.tolist() for t in got] == \
        [s.tolist() for s in shards[1:] + shards[:1]]
    rep = tmesh.put_replicated(mesh, np.arange(5))
    assert len(rep) == 4 and all(r is rep[0] for r in rep)


def test_parallel_count_and_composition(meshes):
    jmesh, mesh = meshes
    from bionumpy_tpu.parallel.kmer_parallel import shard_flat_codes as jsfc
    from bionumpy_tpu_torch.parallel.kmer_parallel import shard_flat_codes
    flat, lengths = _packed(3, 200, 10, 50)
    k = 4
    codes, dist = shard_flat_codes(flat, lengths, N_DEV)
    jcodes, jdist = jsfc(flat, lengths, N_DEV)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(dist, jdist)
    c_s = tmesh.put_sharded(mesh, codes)
    d_s = tmesh.put_sharded(mesh, dist)
    jc = _jput(jmesh, codes, P("dp", None))
    jd = _jput(jmesh, dist, P("dp", None))
    got = tpar.parallel_count_kmers(mesh, c_s, d_s, k, 4 ** k)
    want = np.asarray(jpar.parallel_count_kmers(jmesh, jc, jd, k, 4 ** k))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64 and got.sum() == (lengths - k + 1).sum()
    comp = tpar.parallel_composition(mesh, c_s, d_s)
    np.testing.assert_array_equal(
        comp.numpy(), np.asarray(jpar.parallel_composition(jmesh, jc, jd)))
    np.testing.assert_array_equal(comp.numpy(), np.bincount(flat, minlength=4))


def test_sharded_pipeline_step(meshes):
    jmesh, mesh = meshes
    from bionumpy_tpu_torch.parallel.kmer_parallel import shard_flat_codes
    flat, lengths = _packed(21, 150, 5, 70)
    k = 5
    codes, dist = shard_flat_codes(flat, lengths, N_DEV)
    got = tpar.sharded_pipeline_step(mesh, k, 4 ** k)(
        tmesh.put_sharded(mesh, codes), tmesh.put_sharded(mesh, dist))
    want = jpar.sharded_pipeline_step(jmesh, k, 4 ** k)(
        _jput(jmesh, codes, P("dp", None)), _jput(jmesh, dist, P("dp", None)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["k31", "duplicate_heavy"])
def test_sharded_sparse_count(meshes, case):
    """Per-shard packed tables gathered and merged: equal to JAX's merged
    limbs and counts and to the host recount; duplicates summed."""
    jmesh, mesh = meshes
    from bionumpy_tpu_torch.parallel.sparse_parallel import host_merge_check
    if case == "k31":
        flat, lengths = _packed(7, 300, 20, 80)
        k, cap = 31, 1 << 11
    else:
        rng = np.random.default_rng(11)
        flat = np.tile(rng.integers(0, 4, 60).astype(np.uint8), 64)
        lengths = np.full(64, 60)
        k, cap = 21, 1 << 9
    words, ends, n_true = tpar.shard_packed_reads(flat, lengths, N_DEV)
    jw, je, jn = jpar.shard_packed_reads(flat, lengths, N_DEV)
    for a, b in ((words, jw), (ends, je), (n_true, jn)):
        np.testing.assert_array_equal(a, b)
    keys, counts, n_unique = tpar.sharded_sparse_count_step(mesh, k, cap)(
        tmesh.put_sharded(mesh, words.view(np.int32)),
        tmesh.put_sharded(mesh, ends), n_true)
    nu = int(n_unique)
    m_lo, m_hi, j_counts, j_nu = [np.asarray(x) for x in
                                  jpar.sharded_sparse_count_step(
                                      jmesh, k, cap)(
        _jput(jmesh, words, P("dp", None)), _jput(jmesh, ends, P("dp", None)),
        _jput(jmesh, n_true, P("dp")))]
    assert nu == int(j_nu)
    np.testing.assert_array_equal(keys[:nu].numpy().view(np.uint64),
                                  _keys(m_lo[:nu], m_hi[:nu]))
    np.testing.assert_array_equal(counts[:nu].numpy(), j_counts[:nu])
    exp_h, exp_c = host_merge_check(flat, lengths, k)
    np.testing.assert_array_equal(keys[:nu].numpy().view(np.uint64), exp_h)
    np.testing.assert_array_equal(counts[:nu].numpy(), exp_c)
    if case == "duplicate_heavy":
        assert counts[:nu].max() >= 64


def _fold_inputs(seed, n_batches=3):
    out = []
    for b in range(n_batches):
        flat, lengths = _packed(seed + b, 120, 30, 90)
        out.append((flat, lengths, *tpar.shard_packed_reads(flat, lengths,
                                                            N_DEV)))
    return out


@pytest.mark.parametrize("kind", ["kmers", "minimizers"])
def test_fold_steps(meshes, kind):
    """Three batches through the accumulating steps: the accumulator, the
    folded meta (max n_unique, total n_valid) and the live count equal
    JAX's after every batch."""
    jmesh, mesh = meshes
    from bionumpy_tpu.parallel import sparse_parallel as jsp
    from bionumpy_tpu.pipeline import _device_merge_fns, _meta_fold_fns
    from bionumpy_tpu_torch.parallel import sparse_parallel as tsp
    from bionumpy_tpu_torch.pipeline import _make_acc, _meta_init
    cap, acc_cap = 1 << 10, 1 << 15   # the job's distinct rows fit
    if kind == "kmers":
        k = 25
        step = tsp.sharded_sparse_count_fold_step(mesh, k, cap, acc_cap)
        jstep = jsp.sharded_sparse_count_fold_step(jmesh, k, cap, acc_cap)
    else:
        k, w = 15, 24
        step = tsp.sharded_minimizer_count_fold_step(mesh, k, w, cap,
                                                     acc_cap)
        jstep = jsp.sharded_minimizer_count_fold_step(jmesh, k, w, cap,
                                                      acc_cap)
    _, make_acc, _ = _device_merge_fns()
    rep = NamedSharding(jmesh, P())
    jacc = jax.jit(lambda: make_acc(acc_cap), out_shardings=rep)()
    meta_init, _, _ = _meta_fold_fns()
    jmeta = jax.jit(meta_init, out_shardings=rep)()
    keys, cnt, _ = _make_acc(acc_cap, mesh.lead)
    acc, meta = (keys, cnt), _meta_init(mesh.lead)
    for flat, lengths, words, ends, n_true in _fold_inputs(31):
        acc, meta, nu = step(acc, meta, tmesh.put_sharded(
            mesh, words.view(np.int32)), tmesh.put_sharded(mesh, ends),
            n_true)
        jacc, jmeta, jnu = jstep(jacc, jmeta,
                                 _jput(jmesh, words, P("dp", None)),
                                 _jput(jmesh, ends, P("dp", None)),
                                 _jput(jmesh, n_true, P("dp")))
        nu = int(nu)
        assert nu == int(jnu) < acc_cap
        ja = np.asarray(jacc)
        np.testing.assert_array_equal(acc[0][:nu].numpy().view(np.uint64),
                                      _keys(ja[0, :nu], ja[1, :nu]))
        np.testing.assert_array_equal(acc[1][:nu].numpy(), ja[2, :nu])
        jm = np.asarray(jmeta).astype(np.int64)
        assert meta[0] == jm[0]
        assert meta[1] == jm[1] | (jm[2] << 32)


def test_sharded_pwm_match_step(meshes):
    """Per-shard match positions and counts, and their total, equal
    JAX's; kernel 3's plain version scores here."""
    jmesh, mesh = meshes
    from bionumpy_tpu.parallel.sparse_parallel import \
        sharded_pwm_match_step as jstep_of
    from bionumpy_tpu_torch.parallel.sparse_parallel import \
        sharded_pwm_match_step
    rng = np.random.default_rng(41)
    matrix = np.log(rng.dirichlet(np.ones(4), 9).T).astype(np.float32)
    flat, lengths = _packed(43, 200, 20, 120)
    words, ends, n_true = tpar.shard_packed_reads(flat, lengths, N_DEV)
    cap, thr = 1 << 9, np.float32(-9.0)
    pos, nm, total = sharded_pwm_match_step(mesh, 9, cap)(
        tmesh.put_sharded(mesh, words.view(np.int32)),
        tmesh.put_sharded(mesh, ends), n_true, torch.from_numpy(matrix),
        float(thr))
    jpos, jnm, jtotal = [np.asarray(x) for x in jstep_of(jmesh, 9, cap)(
        _jput(jmesh, words, P("dp", None)), _jput(jmesh, ends, P("dp", None)),
        _jput(jmesh, n_true, P("dp")), jnp.asarray(matrix), jnp.float32(thr))]
    assert int(total) == int(jtotal) > 0
    for d in range(N_DEV):
        h = int(nm[d])
        assert h == int(jnm[d])
        np.testing.assert_array_equal(pos[d][:h].numpy(), jpos[d, :h])


def test_sharded_histogram(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(13)
    values = rng.uniform(0, 50, (N_DEV, 500)).astype(np.float32)
    values[0, :3] = [0.0, 50.0, 60.0]   # both outer edges and one past
    valid = rng.random((N_DEV, 500)) < 0.9
    edges = np.linspace(0.0, 50.0, 11).astype(np.float32)
    got = tpar.sharded_histogram_step(mesh, 10)(
        tmesh.put_sharded(mesh, values), tmesh.put_sharded(mesh, valid),
        torch.from_numpy(edges))
    want = np.asarray(jpar.sharded_histogram_step(jmesh, 10)(
        _jput(jmesh, values, P("dp", None)), _jput(jmesh, valid, P("dp", None)),
        jnp.asarray(edges)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.histogram(values[valid], bins=edges)[0])


def test_sharded_sum_and_n(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(17)
    values = rng.normal(3.0, 1.0, (N_DEV, 256)).astype(np.float32)
    valid = rng.random((N_DEV, 256)) < 0.7
    s, n = tpar.sharded_sum_and_n_step(mesh)(
        tmesh.put_sharded(mesh, values), tmesh.put_sharded(mesh, valid))
    js, jn = jpar.sharded_sum_and_n_step(jmesh)(
        _jput(jmesh, values, P("dp", None)), _jput(jmesh, valid, P("dp", None)))
    assert s.dtype == torch.float32
    assert int(n) == int(jn) == int(valid.sum())
    np.testing.assert_allclose(float(s), float(js), rtol=1e-5)
    np.testing.assert_allclose(float(s), float(values[valid].sum()),
                               rtol=1e-5)


def test_sharded_pileup_and_binned_pileup(meshes):
    jmesh, mesh = meshes
    from bionumpy_tpu.parallel.reductions import \
        sharded_binned_pileup_step as jbinned
    from bionumpy_tpu_torch.parallel.reductions import \
        sharded_binned_pileup_step
    rng = np.random.default_rng(19)
    n_pos = 1000
    starts = rng.integers(0, n_pos - 10, (N_DEV, 64)).astype(np.int32)
    stops = (starts + rng.integers(1, 10, (N_DEV, 64))).astype(np.int32)
    valid = rng.random((N_DEV, 64)) < 0.8
    t_args = [tmesh.put_sharded(mesh, a) for a in (starts, stops, valid)]
    j_args = [_jput(jmesh, a, P("dp", None)) for a in (starts, stops, valid)]
    got = tpar.sharded_pileup_step(mesh, n_pos)(*t_args)
    want = np.asarray(jpar.sharded_pileup_step(jmesh, n_pos)(*j_args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    exp = np.zeros(n_pos + 1, np.int32)
    np.add.at(exp, starts[valid], 1)
    np.add.at(exp, stops[valid], -1)
    np.testing.assert_array_equal(got.numpy(), np.cumsum(exp[:-1]))
    binned = sharded_binned_pileup_step(mesh, 10, 100)(*t_args)
    np.testing.assert_array_equal(
        binned.numpy(), np.asarray(jbinned(jmesh, 10, 100)(*j_args)))
    np.testing.assert_array_equal(binned.numpy(),
                                  want.reshape(10, 100).sum(1))


def test_scaling_proxy():
    """The fixed-work sweep runs on a CPU mesh and reports JAX's fields;
    sizes above the devices given are skipped."""
    from bionumpy_tpu_torch.parallel.scaling import measure
    records = measure(n_devices_list=(1, 4, 16), n_bases=1 << 16,
                      cap=1 << 10, iters=1, devices=CPU8)
    assert [r["n_devices"] for r in records] == [1, 4]
    for r in records:
        assert r["t_with_collectives_s"] > 0
        assert {"collective_overhead_s", "efficiency_proxy",
                "bytes_gathered", "projected_ici_efficiency",
                "local_speedup_vs_1dev", "note"} <= set(r)


def _fastq_bytes(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = "".join("ACGT"[c] for c in rng.integers(0, 4, rng.integers(5, 40)))
        q = "@" * len(s)  # '@' in qualities: the snap must skip it
        out.append(f"@r{i}\n{s}\n+\n{q}\n")
    return "".join(out).encode()


@pytest.mark.parametrize("n_shards", [1, 4, 7])
def test_file_sharding_fastq(tmp_path, n_shards):
    import bionumpy_tpu_torch as tbnp
    from bionumpy_tpu.parallel.file_sharding import \
        shard_byte_ranges as jranges
    from bionumpy_tpu_torch.parallel.file_sharding import (read_shard,
                                                           shard_byte_ranges)
    fq = tmp_path / "reads.fq"
    fq.write_bytes(_fastq_bytes(5, 300))
    ranges = shard_byte_ranges(str(fq), n_shards, "fastq")
    assert ranges == jranges(str(fq), n_shards, "fastq")
    full = tbnp.open(str(fq)).read()
    shards = [read_shard(str(fq), r) for r in ranges]
    assert [n for s in shards for n in s.name.tolist()] == full.name.tolist()
    assert [q for s in shards for q in s.sequence.tolist()] == \
        full.sequence.tolist()


def test_file_sharding_bed(tmp_path):
    import bionumpy_tpu_torch as tbnp
    from bionumpy_tpu.parallel.file_sharding import \
        shard_byte_ranges as jranges
    from bionumpy_tpu_torch.parallel.file_sharding import (read_shard,
                                                           shard_byte_ranges)
    rng = np.random.default_rng(6)
    starts = np.sort(rng.integers(0, 10_000, 500))
    bed = tmp_path / "t.bed"
    bed.write_text("".join(f"chr1\t{s}\t{s + 50}\n" for s in starts))
    ranges = shard_byte_ranges(str(bed), 3, "lines")
    assert ranges == jranges(str(bed), 3, "lines")
    shards = [read_shard(str(bed), r) for r in ranges]
    assert sum(len(s) for s in shards) == len(tbnp.open(str(bed)).read())
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(s.start) for s in shards if len(s)]),
        starts)
