"""fold_device_ms_per_gbase (ms/Gbase, program span): the device time of
the program's table folds in the window (its `table-fold` spans, timed
by CUDA event pairs on the card), per Gbase of the window's input."""


def read(ctx):
    s = ctx.stages.get("table-fold", {}).get("device_seconds")
    if not s or not ctx.gbases:
        return None
    return s * 1e3 / ctx.gbases
