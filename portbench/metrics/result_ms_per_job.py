"""result_ms_per_job (ms, program span): the host time of the program's
`result` spans in the window (the motif call's matches made into rows
and in-row positions after their fetch), per job."""


def read(ctx):
    s = ctx.stages.get("result", {}).get("seconds")
    if s is None or not ctx.jobs:
        return None
    return s * 1e3 / len(ctx.jobs)
