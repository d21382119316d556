"""call_self_ms_per_job (ms, program span): the self time of the
program's call spans (its public entry points) in the window, per job:
host time inside a call that no span under it names."""


def read(ctx):
    own = [r["self_seconds"] for r in ctx.stages.values() if r.get("call")]
    if not own or not ctx.jobs:
        return None
    return sum(own) * 1e3 / len(ctx.jobs)
