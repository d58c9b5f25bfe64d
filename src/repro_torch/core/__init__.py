"""The paper's primary contribution, ported: sparse storage formats, the
bandwidth/balance performance model, microbenchmarks and the distributed
SpMV over a mesh of devices -- plus the Lanczos host application, the SpMV
plans and the matrix corpus the model is validated on."""
from . import (  # noqa: F401
    corpus,
    distributed,
    distributed_plan,
    eigensolver,
    formats,
    io,
    matrices,
    microbench,
    perfmodel,
    plan,
    planconfig,
    spmv,
    tunedb,
    validate,
)
