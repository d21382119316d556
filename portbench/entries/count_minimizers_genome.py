"""Entry: bionumpy_tpu_torch.count_minimizers over a genome in memory as
one EncodedRaggedArray, one row a chromosome, made resident in set-up
(the warm-up's call packs and uploads it; the port's resident cache
keeps it on the card).  A job is one whole-genome minimizer table, as a
minimizer index build counts it.  Checks the (minimizer, windows) table
against a dense count of every window's minimizer."""
import bionumpy_tpu_torch as bt

from portbench import minimizer_genome_reference as G
from portbench import reference as R

LIMITS = {"rows_differing": 0, "digests_differing": 0}


def prepare(ctx, inputs):
    return [bt.EncodedRaggedArray(bt.EncodedArray(inp.flat, bt.DNAEncoding),
                                  inp.lengths) for inp in inputs]


def call(ctx, genome, inp):
    p = ctx.config["minimizers"]
    counts = bt.count_minimizers(genome, p["k"], p["window_size"],
                                 cap=p["cap"], device=ctx.device)
    return {"keys": counts.label_codes, "counts": counts.counts}


def reference(ctx, inp, device):
    p = ctx.config["minimizers"]
    keys, counts = G.minimizer_table(inp.flat, inp.lengths, p["k"],
                                     p["window_size"], device)
    return {"keys": keys, "counts": counts}


def compare(out, ref, device):
    return R.compare_output(out, ref, device)
