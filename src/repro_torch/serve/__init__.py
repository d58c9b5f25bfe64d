from . import batching, engine, resilience  # noqa: F401
from .batching import BackpressureError, BatchPolicy, SpMVFuture  # noqa: F401
from .engine import (  # noqa: F401
    BatchingSpMVServer,
    Engine,
    GenerationConfig,
    SparseOperatorServer,
)
from .resilience import (  # noqa: F401
    CircuitBreaker,
    DeadlineExceeded,
    KernelFault,
    RequestError,
    ResiliencePolicy,
)
