"""fetch_gb_per_s (GB/s, device trace): the bytes of the program's table
fetches in the window (its `D2H` spans) over the device time of the
window's device-to-host copies."""


def read(ctx):
    n_bytes = ctx.stages.get("D2H", {}).get("bytes")
    if ctx.trace is None or not n_bytes:
        return None
    s = ctx.trace.seconds(lambda name, cat: cat == "gpu_memcpy"
                          and "DtoH" in name)
    return n_bytes / s / 1e9 if s > 0 else None
