"""sorted_keys_per_base (keys/base, program span): the keys the program
passed to its table sorts in the window (the rows of its `sort` spans,
padding of the power-of-two bucket and cap reruns included), per input
base of the window's jobs."""


def read(ctx):
    rows = ctx.stages.get("sort", {}).get("rows")
    if not rows or not ctx.gbases:
        return None
    return rows / (ctx.gbases * 1e9)
