"""upload_idle_ms_per_job (ms, device trace): the card's idle time
inside the program's `upload` spans (the resident upload: flatten, pack
and H2D), per job: the stretches of each `upload` range among the
trace's host events that no kernel, copy or memset covers, summed over
the window."""
import bisect

from portbench.trace import merged

SPAN = "upload"


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    t = ctx.trace
    ups = merged([(max(s, t.lo), min(e, t.hi)) for s, e, name in
                  t.host.events if name == SPAN and e > t.lo and s < t.hi])
    if not ups:
        return None
    busy = merged([(s, e) for _, _, s, e in t.device])
    starts = [s for s, _ in busy]
    idle = 0.0
    for lo, hi in ups:
        covered = 0.0
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(busy) and busy[i][0] < hi:
            s, e = busy[i]
            covered += max(0.0, min(e, hi) - max(s, lo))
            i += 1
        idle += hi - lo - covered
    return idle / 1e3 / len(ctx.jobs)
