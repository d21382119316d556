"""ingest_thread_s_per_gbase (s/Gbase, program spans): the host ingest
stages of bionumpy_tpu_torch.instrument over the window, summed over the
pool's threads, per Gbase of the window's input."""

STAGES = ("read", "inflate+parse", "stitch", "parse+pack", "inflate")


def read(ctx):
    seen = [ctx.stages[s]["seconds"] for s in STAGES if s in ctx.stages]
    if not seen or not ctx.gbases:
        return None
    return sum(seen) / ctx.gbases
