"""spectrum_device_ms_per_gbase (ms/Gbase, program span): the device time
of the program's k-mer spectrum reductions in the window (its
`kmer-spectrum` spans: the counts reduced to the spectrum and the
spectrum fetched, timed by CUDA event pairs on the card), per Gbase of
the window's input."""


def read(ctx):
    s = ctx.stages.get("kmer-spectrum", {}).get("device_seconds")
    if not s or not ctx.gbases:
        return None
    return s * 1e3 / ctx.gbases
