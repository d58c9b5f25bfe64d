"""Repeated ground-state solves on the operator the program generates from
the model's parameters: ``holstein_hubbard_operator(HolsteinHubbardParams(
**params))``, planned as it is (the configuration's ``format``), with no CSR
of the program's, so its configuration's generator need hand over none.
The window and the check are ``drivers/lanczos.py``'s, on the generator's
reference (``holstein_hubbard``'s: the benchmark's own CSR of the same
parameters).

Traffic keys: those of ``lanczos``.
"""
from __future__ import annotations

import contextlib

from ..trace import synchronize
from .lanczos import check, control, window  # noqa: F401


def setup(b):
    from repro_torch.core.eigensolver import LanczosBreakdown, lanczos
    from repro_torch.core.matrices import HolsteinHubbardParams, holstein_hubbard_operator
    from repro_torch.core.plan import SpMVPlan

    with b.phase("plan"):
        op = holstein_hubbard_operator(HolsteinHubbardParams(**b.config["params"]))
        if op.shape != (b.n, b.n) or op.nnz != b.nnz:
            raise ValueError(f"the program's operator has shape {op.shape} and {op.nnz} "
                             f"nonzeros; the benchmark's matrix {b.n} rows and {b.nnz}")
        plan = SpMVPlan.compile(op, b.plan_config())
    b.out(f"[setup] plan format={plan.report.format} kernel={plan.report.kernel}")
    with b.phase("inputs"):
        v0s = b.pool(1, b.traffic["pool"], b.vector_dtype)
    t = b.traffic
    with b.phase("warmup"):
        for i in range(t["warmup"]):
            # a breakdown here recurs in the window, which counts it
            with contextlib.suppress(LanczosBreakdown):
                lanczos(plan, b.n, m=t["m"], v0=v0s[i % len(v0s)],
                        reorthogonalize=t["reorthogonalize"],
                        dtype=b.torch_dtype(b.vector_dtype))
        synchronize(b.device)
    return {"plan": plan, "v0s": v0s}
