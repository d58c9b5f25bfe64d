"""Share of the run's completed Lanczos solves that the program replayed
from CUDA graphs: ``repro_torch.core.eigensolver.graph_counts()``,
``replayed_solves`` over ``replayed_solves + eager_solves``, in percent.
The counters cover every solve of the process (set-up's warm-up solves and
the whole window): the probe of the traced stretch in
``spmvbench/drivers/lanczos.py`` does not carry them.  Silent where the
program has no such counter or completed no solve."""


def read(ctx):
    t = ctx.traced
    if not t or not t.get("solves"):
        return None
    try:
        from repro_torch.core.eigensolver import graph_counts
    except ImportError:
        return None
    c = graph_counts()
    done = c["replayed_solves"] + c["eager_solves"]
    return 100.0 * c["replayed_solves"] / done if done else None
