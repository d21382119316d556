"""table_device_ms_per_gbase (ms/Gbase, device trace): device time of the
kernels inside the window other than the port's own CUDA kernels (the
sort, the compaction, the merge, the windowed min, the GC bins), per
Gbase of the window's input.  Copies and memsets are not kernels."""
import re

OWN = re.compile(r"\b(kmer_keys_kernel|kmer_fullsum_kernel|"
                 r"pwm_scores_kernel)\b")


def read(ctx):
    if ctx.trace is None or not ctx.gbases:
        return None
    s = ctx.trace.seconds(lambda name, cat: cat == "kernel"
                          and not OWN.search(name))
    return s * 1e3 / ctx.gbases if s > 0 else None
