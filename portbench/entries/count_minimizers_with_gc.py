"""Entry: bionumpy_tpu_torch.count_minimizers_with_gc on sequences in
memory as one EncodedRaggedArray.  The port's resident copy is dropped
before each job, so every job packs and uploads.  Checks the
(minimizer, windows) table and the GC bins."""
import numpy as np

import bionumpy_tpu_torch as bt
from bionumpy_tpu_torch.ops import resident

from portbench import reference as R

LIMITS = {"rows_differing": 0, "gc_bins_differing": 0,
          "digests_differing": 0}


def prepare(ctx, inputs):
    return [bt.EncodedRaggedArray(bt.EncodedArray(inp.flat, bt.DNAEncoding),
                                  inp.lengths) for inp in inputs]


def call(ctx, seqs, inp):
    resident.invalidate(seqs)
    p = ctx.config["minimizers"]
    table, gc = bt.count_minimizers_with_gc(
        seqs, p["k"], p["window_size"], cap=p["cap"],
        bin_size=p["bin_size"], device=ctx.device)
    return {"keys": table.label_codes, "counts": table.counts,
            "gc_bins": np.asarray(gc)}


def reference(ctx, inp, device):
    p = ctx.config["minimizers"]
    keys, counts = R.minimizer_table(inp.flat, inp.lengths, p["k"],
                                     p["window_size"], device)
    return {"keys": keys, "counts": counts,
            "gc_bins": R.gc_bins(inp.flat, p["bin_size"], device)}


def compare(out, ref, device):
    return R.compare_output(out, ref, device)
