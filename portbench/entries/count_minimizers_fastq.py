"""Entry: bionumpy_tpu_torch.count_minimizers_fastq over the cell's gzip
FASTQ, one whole job a call.  Checks the (minimizer, windows) table and
the stats."""
import bionumpy_tpu_torch as bt

from portbench import reference as R

LIMITS = {"rows_differing": 0, "stats_differing": 0, "digests_differing": 0}


def prepare(ctx, inputs):
    return [inp.path for inp in inputs]


def call(ctx, path, inp):
    p = ctx.config["minimizers"]
    counts, stats = bt.count_minimizers_fastq(
        path, p["k"], p["window_size"], cap=p["cap"], device=ctx.device)
    return {"keys": counts.label_codes, "counts": counts.counts,
            "stats": stats}


def reference(ctx, inp, device):
    p = ctx.config["minimizers"]
    keys, counts = R.minimizer_table(inp.flat, inp.lengths, p["k"],
                                     p["window_size"], device)
    return {"keys": keys, "counts": counts,
            "stats": {"n_reads": inp.n_reads, "n_bases": inp.n_bases,
                      "n_windows": int(counts.sum())}}


def compare(out, ref, device):
    return R.compare_output(out, ref, device)
