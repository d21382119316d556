"""fold_rows_per_base (rows/base, program span): the rows the program's
table folds merged in the window (the rows of its `table-fold` spans:
the accumulator's and each pass table's, padding included), per input
base of the window's jobs.  A table built in one pass folds nothing and
reads nothing here."""


def read(ctx):
    rows = ctx.stages.get("table-fold", {}).get("rows")
    if not rows or not ctx.gbases:
        return None
    return rows / (ctx.gbases * 1e9)
