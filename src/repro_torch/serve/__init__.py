from . import batching, engine, resilience  # noqa: F401
from .batching import BackpressureError, BatchPolicy, SpMVFuture  # noqa: F401
from .engine import BatchingSpMVServer, SparseOperatorServer  # noqa: F401
from .resilience import (  # noqa: F401
    CircuitBreaker,
    DeadlineExceeded,
    KernelFault,
    RequestError,
    ResiliencePolicy,
)
