"""Share of the program's matrix-free kernel launches over stored lanes
that read the lanes as 1-byte codes into a value table, in percent:
``repro_torch.kernels.matrix_free.lane_code_counts()``, ``coded`` over
``coded + streamed``.  The counters are the kernel launch counters, reset
before the window (a replayed CUDA graph adds the launches its capture
counted), so they cover the window's launches.  Silent where the program
has no such counter or made no such launch."""


def read(ctx):
    try:
        from repro_torch.kernels.matrix_free import lane_code_counts
    except ImportError:
        return None
    c = lane_code_counts()
    done = c["coded"] + c["streamed"]
    return 100.0 * c["coded"] / done if done else None
