"""The comparison that decides `correct` fails what it should: the
control (the reference counting under 32-bit keys) in every cell, and a
run whose timed path is broken underneath, once for each fault a cell
can have: a fold that returns its state unchanged, half of each batch
left out, and an answer altered where the program produces it.  The
exchange between chips does not exist in these one-chip cells.  On the
CPU, with the port's plain versions; the card test runs a cell there."""
import time

import numpy as np
import pytest
import torch

import tiny
from portbench.control import control_readings
from portbench.harness import run_cell

FASTQ = ("minimizer21-fastq-gz",)


def run(reg, cell, device="cpu", seconds=0.3, trace=False):
    return run_cell(reg, cell, 2 ** 31 + 99, seconds, trace, device,
                    time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct(tmp_path, cell):
    reg = tiny.registry(tmp_path, "control")
    numbers = control_readings(reg, cell, 17, "cpu")
    assert numbers["rows_differing"] > 0
    assert numbers["digests_differing"] > 0
    assert all(numbers[k] == 0 for k in numbers
               if k not in ("rows_differing", "digests_differing"))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(tmp_path, cell):
    res = run(tiny.registry(tmp_path), cell)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 == c["limit"]
               for c in res["checks"].values())


def _half_batch(monkeypatch):
    from bionumpy_tpu_torch.ops import kmer_kernels, kmers, minimizers
    plain = kmer_kernels.kmer_keys

    def half(*a, **kw):
        keys = plain(*a, **kw).clone()
        keys[keys.numel() // 2:] = kmer_kernels.SENTINEL
        return keys
    monkeypatch.setattr(kmers, "kmer_keys", half)
    monkeypatch.setattr(minimizers, "kmer_keys", half)


def _fold_unchanged(monkeypatch):
    from bionumpy_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "_fold_program_impl",
                        lambda acc, tables, acc_cap: acc)


def _answer_altered(monkeypatch):
    from bionumpy_tpu_torch import pipeline
    from bionumpy_tpu_torch.ops import kmers, minimizers
    fetch = pipeline._fetch_acc

    def fetch_altered(*a, **kw):
        out = fetch(*a, **kw)
        out[1][len(out[1]) // 2] += 1
        return out
    monkeypatch.setattr(pipeline, "_fetch_acc", fetch_altered)
    tables = kmers.sparse_count_tables

    def tables_altered(*a, **kw):
        h, c = tables(*a, **kw)
        c = np.array(c)
        c[len(c) // 2] += 1
        return h, c
    monkeypatch.setattr(kmers, "sparse_count_tables", tables_altered)
    job = minimizers.minimizer_gc_job_packed

    def job_altered(*a, **kw):
        uniq, counts, meta, gc = job(*a, **kw)
        counts = counts.clone()
        counts[int(meta[0]) // 2] += 1
        return uniq, counts, meta, gc
    monkeypatch.setattr(minimizers, "minimizer_gc_job_packed", job_altered)


FAULTS = [("half_batch", _half_batch, tiny.CELLS),
          ("fold_unchanged", _fold_unchanged, FASTQ),
          ("answer_altered", _answer_altered, tiny.CELLS)]


@pytest.mark.parametrize("fault,plant,cell", [
    (name, plant, cell) for name, plant, cells in FAULTS for cell in cells])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault, plant, cell):
    reg = tiny.registry(tmp_path)
    plant(monkeypatch)
    res = run(reg, cell)
    assert res["correct"] is False, (fault, res["checks"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cells_on_the_card(tmp_path, card, cell):
    res = run(tiny.registry(tmp_path), cell, device=card, seconds=1.0,
              trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert "kmer_keys_roofline" in res["metrics"]
