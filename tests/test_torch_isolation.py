"""The port stands alone: bionumpy_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, its sequence/ and ops/ layers import
neither its pipeline nor its parallel steps, the port's main path runs
without loading either, it never falls back to the CPU for lack of a
card, and its kernel module imports without a CUDA compiler."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "bionumpy_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "bionumpy_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imported_roots(f) if name in FORBIDDEN]
    assert bad == []


def _imported_modules(path, package):
    """Every module a file imports, and every name it imports from one,
    as absolute dotted names (relative imports resolved against the
    file's package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            parts = package.split(".")
            base = parts[: len(parts) - node.level + 1] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            yield module
            yield from (f"{module}.{alias.name}" for alias in node.names)


def test_table_layers_import_neither_pipeline_nor_parallel():
    """sequence/ and ops/ sit below the orchestrators: the device tables,
    their merges and their host merge live there."""
    files = [f for layer in ("sequence", "ops")
             for f in sorted((ROOT / "bionumpy_tpu_torch" / layer).rglob(
                 "*.py"))]
    assert len(files) > 20
    above = ("bionumpy_tpu_torch.pipeline", "bionumpy_tpu_torch.parallel")
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imported_modules(
               f, ".".join(f.relative_to(ROOT).parent.parts))
           if any(name == a or name.startswith(a + ".") for a in above)]
    assert bad == []


_MAIN_PATH = """
import gzip, sys
import numpy as np
import bionumpy_tpu_torch as bt
reads = b"".join(b"@r%d\\n%s\\n+\\n%s\\n" % (i, s, b"I" * len(s))
                 for i, s in enumerate([b"ACGTACGTTTGACCA" * 3] * 20))
with open(sys.argv[1], "wb") as f:
    f.write(gzip.compress(reads) * 3)
counts, stats = bt.count_kmers_fastq(sys.argv[1], 21, cap=1 << 12,
                                     acc_cap=1 << 14, device="cpu")
assert stats["n_reads"] == 60 and int(counts.counts.sum()) == stats["n_kmers"]
flat = np.frombuffer(b"\\0\\1\\2\\3" * 40, np.uint8)
bt.kmer_checksum_streamed(flat, np.array([60, 100]), 21, device="cpu")
pwm = bt.PWM.from_dict({"A": [5, 0, 1], "C": [1, 9, 2], "G": [2, 1, 8],
                        "T": [2, 0, 1]})
rows, offs, mstats = bt.get_motif_matches_fastq(sys.argv[1], pwm, 2.0,
                                                device="cpu")
assert mstats["n_reads"] == 60 and mstats["n_matches"] == len(rows) > 0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "bionumpy_tpu"))
print("LOADED", loaded)
"""


def _run(code, *args, env=None):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_main_path_loads_neither_jax_nor_the_jax_package(tmp_path):
    proc = _run(_MAIN_PATH, str(tmp_path / "reads.fq.gz"))
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout


def test_without_a_card_the_default_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from bionumpy_tpu_torch import count_kmers_fastq
    path = tmp_path / "reads.fq"
    path.write_bytes(b"@r\nACGTACGTACGT\n+\nIIIIIIIIIIII\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        count_kmers_fastq(str(path), 5)


def test_without_a_card_the_motif_scan_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from bionumpy_tpu_torch import PWM, get_motif_matches_fastq
    path = tmp_path / "reads.fq"
    path.write_bytes(b"@r\nACGTACGTACGT\n+\nIIIIIIIIIIII\n")
    pwm = PWM.from_dict({"A": [1, 2], "C": [3, 4], "G": [5, 6],
                         "T": [7, 8]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_motif_matches_fastq(str(path), pwm, 0.0)


def test_kernel_module_imports_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = ("import torch\n"
            "from bionumpy_tpu_torch.ops import kmer_kernels as kk\n"
            "w = torch.zeros(1026, dtype=torch.int32)\n"
            "e = torch.tensor([100, 16384], dtype=torch.int32)\n"
            "print(int((kk.kmer_keys(w, e, 31) != kk.SENTINEL).sum()))\n"
            "try:\n"
            "    kk.build()\n"
            "except RuntimeError as err:\n"
            "    print('BUILD', 'nvcc not found' in str(err))\n")
    proc = _run(code, env=env)
    assert proc.returncode == 0, proc.stderr
    # (100 - 30) windows in row 0, (16384 - 100 - 30) in row 1
    assert proc.stdout.split() == [str(70 + 16254), "BUILD", "True"]


def test_pwm_kernel_module_imports_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = ("import torch\n"
            "from bionumpy_tpu_torch.ops import pwm_kernels as pk\n"
            "w = torch.full((1026,), 0x55555555, dtype=torch.int32)\n"
            "m = torch.tensor([[0.0] * 5, [1.0] * 5, [0.0] * 5, [0.0] * 5])\n"
            "print(float(pk.pwm_scores(w, m, 5).sum()))\n"
            "try:\n"
            "    pk.build()\n"
            "except RuntimeError as err:\n"
            "    print('BUILD', 'nvcc not found' in str(err))\n")
    proc = _run(code, env=env)
    assert proc.returncode == 0, proc.stderr
    # every base is C (code 1): 5.0 at each of 16384 positions
    assert proc.stdout.split() == [str(5.0 * 16384), "BUILD", "True"]


_INTERVAL_PATH = """
import sys
import bionumpy_tpu_torch as bt
from bionumpy_tpu_torch import arithmetics as ar
with open(sys.argv[1], "w") as f:
    f.write("chr1\\t0\\t10\\nchr1\\t5\\t30\\nchr2\\t3\\t9\\nchrUn\\t1\\t2\\n")
tracks, stats = bt.binned_pileup_bed(sys.argv[1], {"chr1": 40, "chr2": 20},
                                     bin_size=10, device="cpu")
assert tracks["chr1"].tolist() == [15, 10, 10, 0] and stats["n_intervals"] == 3
iv = bt.open(sys.argv[1]).read()
iv = iv[iv.chromosome == "chr1"]
assert ar.get_pileup_device(iv, 40, device="cpu").to_array().sum() == 35
assert ar.jaccard({"chr1": 40}, iv, iv) == 1.0
assert bt.get_reverse_complement(bt.as_encoded_array("AAC")).to_string() == "GTT"
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "bionumpy_tpu"))
print("LOADED", loaded)
"""


def test_interval_path_loads_neither_jax_nor_the_jax_package(tmp_path):
    proc = _run(_INTERVAL_PATH, str(tmp_path / "iv.bed"))
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout
