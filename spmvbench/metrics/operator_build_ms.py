"""Host milliseconds the program spent building its electron x phonon
operator from the model's parameters in this process, in set-up:
``build_s`` of ``repro_torch.core.matrices.build_stats()`` over every
build.  Silent where the program has no such counter or built none."""


def read(ctx):
    try:
        from repro_torch.core.matrices import build_stats
    except ImportError:
        return None
    s = build_stats()
    return 1e3 * s["build_s"] if s["builds"] else None
