"""Shared pieces of the serving parity suites (``test_torch_serve*.py``).

One scenario -- a script of submits, clock steps, flushes and fault
injections -- runs against the reference's ``repro.serve`` server and the
port's ``repro_torch.serve`` server (on the CPU) on the same matrix (the
reference container's arrays, brought over by ``repro_torch.interop``) and
the same seeded requests.  Each run returns a record of plain values
(numpy results, flags, error classes, stats) that ``assert_same_record``
holds side against side.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from types import ModuleType
from typing import Callable

import jax.numpy as jnp
import numpy as np
import torch

import repro.serve as RS
from _torch_parity import to_port, x64
from repro.testing import faults as RFT
from repro.utils import hw as RHW
from repro_torch import serve as PS
from repro_torch.testing import faults as PFT
from repro_torch.utils.hw import ChipSpec

#: a host chip both packages price alike (the ``cpu`` family; the reference
#: prices its composite SELL form for the platform it runs on, the CPU here)
REF_HOST = RHW.ChipSpec("host_cpu", 1e12, 5e11, 20e9, 8 << 30, 0.0, 0, 32 << 20)
PORT_HOST = ChipSpec(name="host_cpu", peak_flops_fp32=1e12, peak_flops_fp64=5e11,
                     hbm_bytes_per_s=20e9)

#: futures of the two packages agree to this, per request dtype
TOL = {np.float32: 2e-5, np.float64: 1e-12}

#: reference plan-report label -> the port's
LABEL = {"xla": "torch", "pallas": "cuda", "pallas-interpret": "cuda", "loop": "loop"}

#: the ``stats()`` entries that must be equal on both sides
COUNTERS = ("calls", "requests", "batches", "mean_batch_width", "padding_ratio",
            "fast_path_calls", "shed", "retried", "degraded", "deadline_missed",
            "failed", "breaker_trips", "ladder", "pending", "batch_width",
            "deadline_s", "format", "nnz")
#: the ``stats()`` entries only the port has
PORT_ONLY = frozenset({"queue_wait_s"})


class FakeClock:
    """Deterministic monotonic clock the scenarios advance by hand."""

    def __init__(self):
        self.t = 0.0

    def advance(self, dt: float) -> None:
        self.t += dt

    def __call__(self) -> float:
        return self.t


@dataclass(frozen=True)
class Side:
    """One package's serving surface, as a scenario drives it."""

    name: str
    serve: ModuleType               # BatchingSpMVServer, errors, ResiliencePolicy
    faults: ModuleType
    composite: str                  # the label of the composite backend
    server_kw: dict
    vec: Callable                   # numpy vector -> the package's vector
    mat: Callable                   # reference container -> the package's
    arr: Callable                   # the package's vector -> numpy

    def server(self, *, clock=None, **kw):
        return self.serve.BatchingSpMVServer(clock=clock or FakeClock(),
                                             **{**self.server_kw, **kw})

    def requests(self, n: int, k: int, seed: int = 0, dtype=np.float32) -> list:
        rng = np.random.default_rng(seed)
        return [self.vec(rng.standard_normal(n).astype(dtype)) for _ in range(k)]

    def context(self, dtype=np.float32):
        """The reference needs JAX's x64 mode for f64 requests."""
        return x64(dtype == np.float64) if self.name == "ref" else contextlib.nullcontext()


REF = Side("ref", RS, RFT, "xla", {"chip": REF_HOST}, jnp.asarray, lambda c: c, np.asarray)
PORT = Side("port", PS, PFT, "torch", {"chip": PORT_HOST, "device": "cpu"},
            torch.from_numpy, to_port, lambda t: t.numpy())


def run_both(scenario, *args, dtype=np.float32, **kw) -> tuple[dict, dict]:
    """``scenario(side, *args, **kw)`` on the reference, then on the port."""
    out = []
    for side in (REF, PORT):
        with side.context(dtype):
            out.append(scenario(side, *args, **kw))
    return out[0], out[1]


def assert_same_stats(ref: dict, port: dict) -> None:
    """Every counter equal, the kernel label through ``LABEL``, the model's
    predictions equal to rounding; the port's own entries (``PORT_ONLY``)
    beside them."""
    assert set(ref) == set(port)
    for name in ref:
        r, p = ref[name], port[name]
        assert set(r) == set(p) - PORT_ONLY and PORT_ONLY <= set(p), name
        assert p["queue_wait_s"] >= 0.0, name
        for key in COUNTERS:
            assert r[key] == p[key], (name, key, r[key], p[key])
        assert LABEL[r["kernel"]] == p["kernel"], name
        for key in ("predicted_gflops", "predicted_bytes_per_call"):
            assert np.isclose(r[key], p[key], rtol=1e-9, atol=0), (name, key)


def assert_same_record(ref: dict, port: dict, dtype=np.float32) -> None:
    """Field by field: arrays (keys "y...") within ``TOL[dtype]``, stats
    (keys "stats...") by :func:`assert_same_stats`, the rest equal."""
    assert set(ref) == set(port)
    tol = TOL[dtype]
    for key, r in ref.items():
        p = port[key]
        if key.startswith("stats"):
            assert_same_stats(r, p)
        elif key.startswith("y"):
            assert len(r) == len(p), key
            for a, b in zip(r, p):
                if a is None or b is None:
                    assert a is None and b is None, key
                    continue
                assert a.dtype == b.dtype and a.shape == b.shape, key
                np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=key)
        else:
            assert r == p, (key, r, p)


def error_names(futs) -> list:
    """The class name of each future's structured error (None: a value)."""
    return [None if (e := f.error()) is None else type(e).__name__ for f in futs]
