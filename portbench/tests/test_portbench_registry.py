"""Parts are found by name: a throwaway cell, configuration, entry and
metric put in a temporary directory run without an edit to any
committed file."""
import json
import textwrap
import time

import tiny
from portbench.harness import run_cell
from portbench.registry import HERE, Registry


def test_committed_parts_resolve():
    reg = Registry([HERE])
    for w in reg.benchmark["workloads"]:
        cell = reg.cell(w["name"])
        assert cell["config"] == w["config"]
        reg.entry(cell["entry"])
    for c in reg.benchmark["configs"]:
        assert reg.config(c["name"])["name"] == c["name"]
    for kind in ("end_to_end", "per_layer"):
        for m in reg.benchmark[kind]:
            assert callable(reg.metric(m["name"]).read)
    names = [m["name"] for m in reg.metrics_of("kmer31-resident", False)]
    assert names == ["setup_s", "job_mbases_per_s"]
    names = [m["name"] for m in reg.metrics_of("kmer31-resident", True)]
    assert "kmer_keys_roofline" in names and "setup_s" not in names
    # a metric that lists its cells is reported in those alone
    bench = json.loads(json.dumps(reg.benchmark))
    bench["per_layer"].append({"name": "ingest_thread_s_per_gbase",
                               "workloads": ["minimizer21-fastq-gz"]})
    listed = Registry([HERE], benchmark=bench)
    assert "ingest_thread_s_per_gbase" in [
        m["name"] for m in listed.metrics_of("minimizer21-fastq-gz", True)]
    assert "ingest_thread_s_per_gbase" not in [
        m["name"] for m in listed.metrics_of("kmer31-resident", True)]


def test_throwaway_parts_by_name(tmp_path):
    base = tiny.registry(tmp_path)
    for kind in ("configs", "cells", "entries", "metrics"):
        (tmp_path / kind).mkdir(exist_ok=True)
    cfg = base.config("kmer31-illumina-ecoli")
    cfg["name"] = "kmer15-throwaway"
    cfg["kmers"]["k"] = 15
    cfg["reads"]["n_arrays"], cfg["reads"]["reads_per_array"] = 2, 500
    (tmp_path / "configs" / "kmer15-throwaway.json").write_text(
        json.dumps(cfg))
    (tmp_path / "cells" / "kmer15-throwaway-arrays.json").write_text(
        json.dumps({"config": "kmer15-throwaway", "entry": "count_kmers",
                    "input": {"form": "read_arrays"}}))
    (tmp_path / "metrics" / "jobs_seen.py").write_text(textwrap.dedent("""
        def read(ctx):
            return float(len(ctx.jobs))
        """))
    bench = json.loads(json.dumps(base.benchmark))
    bench["workloads"].append({"name": "kmer15-throwaway-arrays",
                               "config": "kmer15-throwaway",
                               "traffic": "kmer15-throwaway-arrays",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "jobs_seen", "unit": "jobs",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["kmer15-throwaway-arrays"]})
    reg = Registry([str(tmp_path), HERE], benchmark=bench)
    res = run_cell(reg, "kmer15-throwaway-arrays", 3, 0.3, False, "cpu",
                   time.perf_counter(), log=lambda m: None)
    assert res["correct"], res
    assert res["metrics"]["jobs_seen"]["value"] == res["attempted"] > 1
    assert list(res["metrics"]) == ["setup_s", "job_mbases_per_s",
                                    "jobs_seen"]
