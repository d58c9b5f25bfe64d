"""Launches of the port's counted CUDA kernels per plan call over the
traced stretch (``repro_torch.kernels.cuda_build.launch_counts()``)."""


def read(ctx):
    t = ctx.traced
    if not t or not t.get("units") or "launches" not in t:
        return None
    return t["launches"] / t["units"]
