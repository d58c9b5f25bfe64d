"""How late the load generator submitted, 95th percentile: submission time
less due time.  Read over the rest of the traced run's window, after the
profiled stretch (the profiler slows the host path) and from the first
request the generator sent within one deadline of its due time again, so
that it describes the cell's own load.  The benchmark's clock."""
import numpy as np


def read(ctx):
    r = ctx.result
    if "late_s" not in r or r.get("trace_end_s") is None:
        return None
    late = r["late_s"][r["due_s"] >= r["trace_end_s"]]
    late = late[~np.isnan(late)]
    on_time = np.flatnonzero(late <= ctx.bench.traffic["deadline_s"])
    if not len(on_time):
        return None
    return float(np.percentile(late[on_time[0]:], 95)) * 1e3
