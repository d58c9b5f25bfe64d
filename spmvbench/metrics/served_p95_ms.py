"""The 95th percentile of the latency of every request due in the window,
from when it was due under the open-loop schedule to when its answer was
complete on the device; a failed, shed or unanswered request counts as
infinitely late.  Silent where that puts the percentile at infinity (the
run's check fails then).  Host clock."""
import math

import numpy as np


def read(ctx):
    lat = ctx.result.get("latency_s")
    if lat is None or not len(lat):
        return None
    p95 = float(np.percentile(lat, 95)) * 1e3
    return p95 if math.isfinite(p95) else None
