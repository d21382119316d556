"""kmer_keys_roofline (%, device trace): the least time the kernel's bytes
take at the card's peak bandwidth, over the device time of the kernels
named here inside the window.  Bytes are counted once per job from its
inputs, whatever reads them again: the 2-bit codes (n_bases / 4), one
int32 row end per read, and one int64 key per base written."""
import re

KERNELS = re.compile(r"\bkmer_keys_kernel\b")


def job_bytes(n_bases: int, n_reads: int) -> int:
    return n_bases // 4 + 4 * n_reads + 8 * n_bases


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.seconds(lambda name, cat: cat == "kernel"
                          and KERNELS.search(name))
    if s <= 0:
        return None
    need = sum(job_bytes(j.n_bases, j.n_reads) for j in ctx.jobs)
    return 100 * need / ctx.peaks["hbm_bytes_per_s"] / s
