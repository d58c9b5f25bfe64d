"""How long requests waited in the server's queue, 95th percentile: from
enqueue to the flush that took them (answered or shed for their deadline),
the upper edge of the 50 us bin of the program's histogram
(``repro_torch.serve.batching.queue_wait_counts()``) that holds it.  Over
every request of the run: set-up's warm-up traffic and the profiled
stretch with the window.  Silent where the program has no such counter,
nothing was counted, or the percentile lies past the histogram's 10 ms."""
import math


def read(ctx):
    try:
        from repro_torch.serve.batching import queue_wait_quantile
    except ImportError:
        return None
    p95 = queue_wait_quantile(0.95)
    return p95 * 1e3 if math.isfinite(p95) else None
