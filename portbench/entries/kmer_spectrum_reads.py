"""Entry: bionumpy_tpu_torch.kmer_spectrum over reads already in memory
as one EncodedRaggedArray, uploaded once in set-up (the port's resident
cache keeps its blocks on the card).  A job is GenomeScope's input, the
canonical k-mer spectrum of the whole read set (`jellyfish count -C`
then `jellyfish histo`): the table is built and reduced on the card and
only the spectrum is fetched.  Checks the spectrum as a table keyed by
the count (spectrum_table), so reference.compare_output and
reference.digest serve unchanged, against
portbench/kmer_spectrum_reference.py: the bins 1..max_count, and in row
0, whose bin is always empty, a checksum of every bin, which each job's
digest adds."""
import numpy as np
import torch

import bionumpy_tpu_torch as bt

from portbench import kmer_spectrum_reference as S
from portbench import reference as R

LIMITS = {"rows_differing": 0, "digests_differing": 0}

# odd 64-bit weights of the bins (the golden ratio's multiples): a count
# added to a bin, lost from one or moved between two changes the sum
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def checksum(h: np.ndarray) -> int:
    """sum(h[c] * w[c]) mod 2^63 over every bin c, w[c] = (c + 1) times
    the golden ratio's 64-bit fraction, made odd."""
    c = np.arange(1, len(h) + 1, dtype=np.uint64)
    w = (c * _GOLDEN) | np.uint64(1)
    total = (np.asarray(h).astype(np.uint64) * w).sum(dtype=np.uint64)
    return int(total) & ((1 << 63) - 1)


def spectrum_table(h: np.ndarray) -> dict:
    """The spectrum h as the table compared and digested: key c, count
    h[c], for c in 1..max_count, and key 0 with checksum(h).
    reference.digest adds every DIGEST_STRIDE-th row from row 0, so every
    job's digest holds every bin, the genomic peak's too."""
    counts = np.array(h, dtype=np.int64)
    counts[0] = checksum(h)
    return {"keys": np.arange(len(h), dtype=np.int64), "counts": counts}


def prepare(ctx, inputs):
    return [bt.EncodedRaggedArray(bt.EncodedArray(inp.flat, bt.DNAEncoding),
                                  inp.lengths) for inp in inputs]


def call(ctx, reads, inp):
    p = ctx.config["kmers"]
    h = bt.kmer_spectrum(reads, p["k"], canonical=p["canonical"],
                         max_count=p["max_count"], cap=p["cap"],
                         device=ctx.device)
    return spectrum_table(h)


def reference(ctx, inp, device):
    p = ctx.config["kmers"]
    h = S.kmer_spectrum(inp.flat, inp.lengths, p["k"], p["canonical"],
                        p["max_count"], device)
    return {name: torch.as_tensor(v, device=device)
            for name, v in spectrum_table(h.cpu().numpy()).items()}


def compare(out, ref, device):
    return R.compare_output(out, ref, device)
