"""Serving engines: token decode waves and micro-batched SpMV operators.

Two serving surfaces share this module because they are the same regime at
two granularities:

* ``Engine`` -- prefill, then decode waves over a fixed slot batch.  Decode
  is the paper's regime: every step streams all active weights (and the KV
  cache) against one activation vector per slot, a bandwidth-bound
  matrix-vector pipeline.  Requests in a wave share positions (prompts
  padded to the wave's max).  The KV cache is allocated once on the device
  and written in place at each step's position.

* ``BatchingSpMVServer`` -- the operator-level analogue: concurrent
  ``y = A @ x`` requests against a registered matrix are coalesced into a
  single ``plan.spmm(X)``, so the matrix is streamed once per batch instead
  of once per request (``serve.batching`` holds the queue machinery,
  ``perfmodel.select_batch_width`` the width policy).
  ``SparseOperatorServer`` remains as the direct-call compatibility name.
  ``register_distributed`` serves a ``DistributedSpMVPlan`` over a mesh the
  same way: a flush is one distributed ``plan.spmm``.
"""
from __future__ import annotations

import time
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..core import perfmodel as PM
from ..core.plan import _LABEL_STREAM, SpMVPlan
from ..core.planconfig import coerce_config
from ..core.validate import POLICIES
from ..models.registry import Model
from ..utils.hw import H100, default_device
from ..utils.tree import leaves, param_bytes
from .batching import BatchPolicy, OperatorQueue, SpMVFuture
from .kv_cache import SlotManager, cache_bytes, zeros_like_shapes
from .resilience import ResiliencePolicy, degradation_ladder


@dataclass
class GenerationConfig:
    """Sampling knobs for one ``Engine.generate`` wave."""

    max_new_tokens: int = 32
    temperature: float = 0.0         # 0 => greedy
    eos_id: int = -1                 # -1 => never stops early
    seed: int = 0


class Engine:
    """Token serving engine: prefill, then decode steps over a fixed slot
    batch, on ``device`` (default the card; "cpu" runs on the host).

    ``params`` is the model's module (moved to ``device``) or a state dict
    loaded into a module the model builds there.  Greedy sampling is
    ``argmax``; ``temperature > 0`` draws with ``torch.multinomial`` from a
    generator seeded with ``GenerationConfig.seed`` (not bitwise
    ``jax.random.categorical``).  The step's tokens reach the host once a
    step."""

    def __init__(self, model: Model, params, *, batch_size: int, max_len: int,
                 device=None):
        self.model = model
        self.device = default_device(device)
        if isinstance(params, Mapping):
            module = model.build(self.device)
            module.load_state_dict(params)
        elif isinstance(params, nn.Module):
            module = params.to(self.device)
        else:
            raise TypeError(f"params must be the model's nn.Module or its state dict, "
                            f"got {type(params).__name__}")
        self.params = module
        self.batch_size = batch_size
        self.max_len = max_len
        self.slots = SlotManager(batch_size, max_len)
        self.cache = zeros_like_shapes(model.cache_shape(batch_size, max_len), self.device)

    def _sample(self, logits: torch.Tensor, cfg: GenerationConfig, gen) -> torch.Tensor:
        if cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def generate(self, prompts: np.ndarray, cfg: GenerationConfig = GenerationConfig()):
        """Run one synchronized prefill + decode wave.

        Args:
            prompts: (n, prompt_len) integer token ids, n <= batch_size;
                prompts share positions (pad to the wave's max upstream).
            cfg: sampling configuration for the wave.

        Returns:
            A list of n generated-token lists (ints), one per prompt.
        """
        n, plen = prompts.shape
        if n > self.batch_size:
            raise ValueError(f"{n} prompts for {self.batch_size} slots")
        B = self.batch_size
        toks = np.zeros((B, plen), np.int64)
        toks[:n] = prompts
        for r in range(n):
            self.slots.admit(r, plen)
        for t in leaves(self.cache):   # SSM states carry into a prefill
            t.zero_()
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.as_tensor(toks, device=self.device)}, self.cache)
        pos = plen
        outs: list[list[int]] = [[] for _ in range(B)]
        tok = self._sample(logits, cfg, gen)
        host = tok.tolist()
        for i in range(n):
            self.slots.record_token(i, host[i], cfg.eos_id, cfg.max_new_tokens)
            outs[i].append(host[i])
        while pos < self.max_len - 1 and self.slots.active_mask()[:n].any():
            logits, cache = self.model.decode_step(self.params, cache, tok, pos)
            tok = self._sample(logits, cfg, gen)
            pos += 1
            host = tok.tolist()
            active = self.slots.active_mask()
            for i in range(n):
                if active[i]:
                    self.slots.record_token(i, host[i], cfg.eos_id, cfg.max_new_tokens)
                    outs[i].append(host[i])
        return [outs[i] for i in range(n)]

    # --- accounting for the roofline discussion ---
    def decode_bytes_per_token(self) -> float:
        """Weights + cache bytes streamed per generated token (model-level)."""
        w = param_bytes(self.model.param_shapes())
        c = cache_bytes(self.model.cache_shape(self.batch_size, self.max_len))
        return w + c / max(1, self.batch_size)


class BatchingSpMVServer:
    """Micro-batching SpMV serving: coalesce concurrent requests into SpMM.

    A single SpMV re-streams the whole matrix per call, so single-request
    throughput saturates at BW / balance.  Batching k concurrent requests
    into one ``plan.spmm(X)`` streams the matrix once for all k
    (``perfmodel.spmm_balance_of``).

    Each registered operator gets a compiled ``SpMVPlan`` on the server's
    device plus an ``OperatorQueue`` whose flush width comes from the SpMM
    roofline of the plan's SpMM kernel (``perfmodel.select_batch_width``)
    unless overridden.  Requests enter through ``submit`` / ``submit_many``
    and resolve as ``SpMVFuture``s when the batch flushes: width reached,
    deadline elapsed (checked at submission and by ``pump()``), or a
    consumer forcing ``result()``.  Partial batches are zero-padded to the
    policy width.  ``max_pending`` caps each queue; beyond it ``submit``
    sheds load with ``BackpressureError``.

    The batcher is cooperative and single-threaded; ``clock`` is injectable
    so deadline behaviour is testable without sleeping.
    """

    def __init__(self, *, backend: str = "auto", chip=None,
                 am: PM.AccessModel | None = None,
                 max_batch: int | None = None, deadline_s: float = 1e-3,
                 max_pending: int = 256, pad_partial: bool = True,
                 clock=time.monotonic, validate: str = "strict",
                 resilience=None, device=None):
        """Args:
            backend: plan backend ("auto" | "cuda" | "torch" |
                "loop_reference").
            chip: roofline parameters; defaults to the H100 data sheet
                (``core.microbench.card_chip()`` is the card as measured).
            am: access model (byte widths) for the batching policy.
            max_batch: server-wide flush-width override; None lets
                ``perfmodel.select_batch_width`` decide per operator.
            deadline_s: default latency bound for partial batches.
            max_pending: default per-operator queue cap (backpressure).
            pad_partial: zero-pad partial batches to the policy width.
            clock: monotonic time source (injectable for tests).
            validate: request-vector policy ("strict" | "repair" | "off")
                applied at ``submit`` and to registered matrices
                (``core.validate``).
            resilience: a ``serve.resilience.ResiliencePolicy`` for the
                flush path; None uses the defaults, and
                ``ResiliencePolicy(enabled=False)`` the legacy
                propagate-and-strand behaviour.
            device: where every plan runs; None means the card and raises
                when there is none (``utils.hw.default_device``), "cpu"
                runs the plain PyTorch versions on the host.
        """
        if validate not in POLICIES:
            raise ValueError(f"validate={validate!r}; expected one of {POLICIES}")
        self.device = default_device(device)
        self.backend = backend
        self.chip = chip or H100
        self.am = am
        self.max_batch = max_batch
        self.deadline_s = deadline_s
        self.max_pending = max_pending
        self.pad_partial = pad_partial
        self._clock = clock
        self.validate = validate
        self.resilience = resilience if resilience is not None else (
            ResiliencePolicy())
        self._queues: dict[str, OperatorQueue] = {}

    # -- registration -------------------------------------------------------

    def _policy(self, policy_matrix, stream_backend: str, max_batch, deadline_s,
                max_pending) -> BatchPolicy:
        # a flush runs the plan's SpMM: its kernel's stream-byte regime
        # (``stream_backend``) prices the width
        width = max_batch if max_batch is not None else self.max_batch
        if width is None:
            width = PM.select_batch_width(
                policy_matrix, am=self.am, chip=self.chip, backend=stream_backend).width
        return BatchPolicy(
            width=int(width),
            deadline_s=self.deadline_s if deadline_s is None else deadline_s,
            pad_to_width=self.pad_partial,
            max_pending=self.max_pending if max_pending is None else max_pending,
        )

    def _server_config(self, config, plan_kw, *, api: str):
        """Fold kwargs into a ``PlanConfig`` and apply the server's floor:
        the server owns the chip and the device, ``backend="auto"`` defers
        to the server-wide backend, and ``validate=None`` inherits the
        server's validation policy."""
        cfg = coerce_config(config, plan_kw, api=api, stacklevel=4)
        return cfg.replace(
            chip=self.chip, device=self.device,
            backend=self.backend if cfg.backend in (None, "auto") else cfg.backend,
            validate=self.validate if cfg.validate is None else cfg.validate)

    def register(self, name: str, matrix, *, max_batch: int | None = None,
                 deadline_s: float | None = None,
                 max_pending: int | None = None,
                 config=None, **plan_kw):
        """Compile ``matrix`` into a plan + batching queue; returns the report.

        Compilation is idempotent (plans are memoized on the container);
        re-registering a name replaces its queue and resets its stats.

        Args:
            name: operator key used by ``submit`` / ``spmv`` / ``stats``.
            matrix: any ``core.formats`` container.
            max_batch: flush-width override for this operator.
            deadline_s / max_pending: per-operator policy overrides.
            config: a ``core.planconfig.PlanConfig`` carrying the compile
                options (``format``, ``sigma``, ``value_dtype``, a
                per-operator ``backend``, ``validate``; ``chip`` and
                ``device`` are the server's).
            **plan_kw: deprecated bare-kwarg aliases for the config fields
                (one ``DeprecationWarning``, folded into a config).
        """
        cfg = self._server_config(config, plan_kw,
                                  api="BatchingSpMVServer.register")
        plan = SpMVPlan.compile(matrix, cfg)
        # the width policy prices the container and kernel the plan actually
        # executes (after any format="auto" conversion), not the source
        policy = self._policy(plan.matrix, _LABEL_STREAM[plan.report.spmm_kernel],
                              max_batch, deadline_s, max_pending)

        def rebuild(be, _m=matrix, _cfg=cfg):
            # matrix already checked at register time
            return SpMVPlan.compile(_m, _cfg.replace(backend=be, validate="off"))

        self._queues[name] = OperatorQueue(
            plan, policy, self._clock,
            validate=self.validate, resilience=self.resilience,
            rebuild=rebuild,
            ladder=degradation_ladder(plan.report.format, plan.report.kernel,
                                      plan.matrix, plan.device))
        return plan.report

    def register_distributed(self, name: str, matrix, *, mesh=None,
                             variant: str = "overlap",
                             max_batch: int | None = None,
                             deadline_s: float | None = None,
                             max_pending: int | None = None,
                             config=None, **plan_kw):
        """Mesh-aware registration: compile ``matrix`` into a
        ``DistributedSpMVPlan`` over ``mesh`` (default: every card, or one
        shard on the server's device when that is not a card).  Batching
        applies unchanged: ``plan.spmm`` is one distributed pass, so a flush
        also pays the x-shard exchange once for the batch.  The width is
        priced on the CSR's composite stream (the reference's).
        ``config.backend`` (``"auto"`` = the server-wide setting) selects
        the slab backend.  The degrade ladder is ``loop_reference`` under a
        ``torch`` slab backend and empty under ``cuda`` (a failing card
        kernel ends in a ``KernelFault``, never in a plain version's
        answer) or ``loop_reference``."""
        from ..core.distributed import make_mesh_1d
        from ..core.distributed_plan import _as_csr, compile_distributed_spmv_plan
        from ..core.validate import validate_matrix

        cfg = self._server_config(config, plan_kw,
                                  api="BatchingSpMVServer.register_distributed")
        if mesh is None:
            mesh = make_mesh_1d(device=None if self.device.type == "cuda" else self.device)
        matrix = validate_matrix(matrix, policy=self.validate)
        plan = compile_distributed_spmv_plan(matrix, mesh, variant=variant, config=cfg)
        policy = self._policy(_as_csr(matrix), "torch", max_batch, deadline_s, max_pending)
        ladder = ["loop_reference"] if plan.slab_backend == "torch" else []

        def rebuild(be, _m=matrix, _mesh=mesh, _v=variant, _cfg=cfg):
            return compile_distributed_spmv_plan(_m, _mesh, variant=_v,
                                                 config=_cfg.replace(backend=be))

        self._queues[name] = OperatorQueue(
            plan, policy, self._clock,
            validate=self.validate, resilience=self.resilience,
            rebuild=rebuild, ladder=ladder)
        return plan.report

    # -- batched submission -------------------------------------------------

    def submit(self, name: str, x: torch.Tensor, *,
               timeout_s: float | None = None) -> SpMVFuture:
        """Enqueue one ``y = A @ x`` request; returns its future.

        Flushes the operator's batch when the policy width is reached or
        its deadline has elapsed; width-1 policies execute synchronously
        (exactly ``plan(x)``).  Raises ``BackpressureError`` at the
        ``max_pending`` cap.  ``timeout_s`` overrides the resilience
        policy's per-request deadline.
        """
        return self._queues[name].submit(x, timeout_s=timeout_s)

    def submit_many(self, name: str, xs) -> list[SpMVFuture]:
        """Submit a burst of requests in order; returns their futures."""
        return [self.submit(name, x) for x in xs]

    def pump(self) -> int:
        """Flush every operator queue whose deadline has elapsed (the
        cooperative stand-in for a background flusher); returns the number
        of requests answered."""
        return sum(q.flush() for q in self._queues.values() if q.due())

    def flush(self, name: str | None = None) -> int:
        """Force-flush one operator (or all); returns requests answered."""
        if name is not None:
            return self._queues[name].flush()
        return sum(q.flush() for q in self._queues.values())

    def pending(self, name: str) -> int:
        """Queued (not yet executed) request count for one operator."""
        return len(self._queues[name])

    # -- direct (unbatched) paths ------------------------------------------

    def plan(self, name: str) -> SpMVPlan:
        """The compiled plan behind a registered operator."""
        return self._queues[name].plan

    def spmv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """One synchronous query, bypassing the batcher (counted in stats)."""
        self._queues[name].stats.calls += 1
        return self._queues[name].plan(x)

    def spmm(self, name: str, X: torch.Tensor) -> torch.Tensor:
        """One caller-assembled batch: X (N, K) -> Y (M, K), counted as K
        queries and one batch."""
        self._queues[name].stats.record_batch(int(X.shape[1]))
        return self._queues[name].plan.spmm(X)

    # -- accounting ---------------------------------------------------------

    def stats(self) -> dict:
        """Per-operator serving stats.

        Each entry carries the batching counters: ``requests`` (submitted),
        ``calls`` (queries answered), ``batches``, ``mean_batch_width``
        (real columns per flush), ``padding_ratio`` (zero columns /
        streamed columns), ``fast_path_calls``, the policy's
        ``batch_width`` / ``deadline_s``, the robustness counters --
        ``shed``, ``retried``, ``degraded``, ``deadline_missed``,
        ``failed``, ``breaker_trips`` and the remaining degrade ``ladder``
        -- ``queue_wait_s`` (the seconds requests waited from enqueue to the
        flush that took them, summed; the port's own) and the plan report's
        ``format``, ``kernel``, ``nnz``, ``predicted_gflops`` and
        ``predicted_bytes_per_call``.  A
        distributed operator adds the mesh-level ``variant``, ``parts``,
        ``slab_format``, ``imbalance``, ``local_fraction`` and
        ``collective_bytes_per_call`` (the modelled exchange).
        """
        out = {}
        for name, q in self._queues.items():
            r = q.plan.report
            st = q.stats
            out[name] = {
                "calls": st.calls,
                "requests": st.requests,
                "batches": st.batches,
                "mean_batch_width": st.mean_batch_width,
                "padding_ratio": st.padding_ratio,
                "fast_path_calls": st.fast_path_calls,
                "shed": st.shed,
                "retried": st.retried,
                "degraded": st.degraded,
                "deadline_missed": st.deadline_missed,
                "failed": st.failed,
                "queue_wait_s": st.queue_wait_s,
                "breaker_trips": q.breaker.trips,
                "ladder": tuple(q.ladder),
                "pending": len(q),
                "batch_width": q.policy.width,
                "deadline_s": q.policy.deadline_s,
                "format": r.format,
                "kernel": r.kernel,
                "nnz": r.nnz,
                "predicted_gflops": r.predicted_gflops,
                "predicted_bytes_per_call": r.balance_bytes_per_flop * 2.0 * r.nnz,
            }
            plan = q.plan
            if hasattr(plan, "variant"):  # distributed plans: mesh-level stats
                out[name].update({
                    "variant": plan.variant,
                    "parts": plan.parts,
                    "slab_format": plan.slab_format,
                    "imbalance": plan.imbalance,
                    "local_fraction": plan.local_fraction,
                    "collective_bytes_per_call": plan.traffic["collective"],
                })
        return out


class SparseOperatorServer(BatchingSpMVServer):
    """Back-compat name for the direct-call serving surface (``register`` +
    ``spmv`` / ``spmm``); new code should use ``BatchingSpMVServer`` and
    the ``submit`` path."""
