"""fetch_d2h_ms_per_job (ms, device trace): device time of the
device-to-host copies inside the window, per job."""


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    s = ctx.trace.seconds(lambda name, cat: cat == "gpu_memcpy"
                          and "DtoH" in name)
    return s * 1e3 / len(ctx.jobs) if s > 0 else None
