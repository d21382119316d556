"""fetch_alloc_ms_per_job (ms, program span): the host time of the
program's `fetch-alloc` spans in the window (a page-locked fetch taking
its host block, a new one locked or a recycled one), per job."""


def read(ctx):
    s = ctx.stages.get("fetch-alloc", {}).get("seconds")
    if s is None or not ctx.jobs:
        return None
    return s * 1e3 / len(ctx.jobs)
