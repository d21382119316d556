"""Small copies of the committed configurations and cells, for runs on
the CPU: the same files with fewer bases and reads, put in a directory
that the registry searches ahead of the committed one."""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.registry import HERE, Registry  # noqa: E402

CELLS = ("minimizer21-genome", "kmer31-resident", "minimizer21-fastq-gz")

# (genome bases, reads, reads a member, reads an array) by size
SIZES = {"tiny": (20_000, 3_000, 500, 1_000),
         "control": (300_000, 6_000, 500, 6_000)}


def _load(kind, name):
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def registry(tmp_path, size: str = "tiny") -> Registry:
    genome, reads, per_member, per_array = SIZES[size]
    for kind in ("configs", "cells"):
        os.makedirs(os.path.join(tmp_path, kind), exist_ok=True)
    parts = []
    for name in ("kmer31-illumina-ecoli", "minimizer21-illumina-ecoli"):
        c = _load("configs", name)
        c["genome"]["chromosome_sizes"] = {"c1": genome * 4 // 5,
                                           "c2": genome // 5}
        c["reads"]["n_reads"] = reads
        c["fastq_gz"]["reads_per_member"] = per_member
        parts.append(("configs", name, c))
    k = parts[0][2]
    k["reads"]["reads_per_array"] = per_array
    k["kmers"]["cap"], k["kmers"]["acc_cap"] = 1 << 20, 1 << 22
    m = _load("configs", "minimizer21-sacCer3-strains")
    m["genome"]["chromosome_sizes"] = {"a": genome // 2, "b": genome // 3,
                                       "c": genome // 6, "d": 25}
    parts.append(("configs", "minimizer21-sacCer3-strains", m))
    for kind, name, data in parts:
        with open(os.path.join(tmp_path, kind, name + ".json"), "w") as f:
            json.dump(data, f)
    return Registry([str(tmp_path), HERE])
