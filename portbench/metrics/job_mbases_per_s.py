"""job_mbases_per_s (Mbases/s, host clock): the input bases of every job
that completed in the window, over the whole window (from the first
job's start to the last job's end)."""


def read(ctx):
    done = sum(j.n_bases for j in ctx.jobs if j.ok)
    return done / ctx.window_s / 1e6 if ctx.window_s > 0 else None
