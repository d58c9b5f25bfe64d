"""The paper's Table-1 microbenchmarks (PD/CS/IS/IR x ADD/SCP) in PyTorch,
and the card's STREAM calibration.

These isolate the three penalties of the SpMV inner loop (Sec. 4.1):
  1. index-array traffic (IS vs CS),
  2. access-granule waste at stride k (CS k=8 vs k=1),
  3. irregularity (IR vs IS; plus Gaussian-stride variants, Fig. 4).

Kernels (Table 1):
  PDADD   s += B[i]             dense packed add (reduction)
  PDSCP   s += A[i] * B[i]      dense packed scalar product
  CSSCP   s += A[i] * B[k*i]    constant-stride direct access
  ISADD   s += B[ind[i]]        indirect, ind(i) = k*i
  ISSCP   s += A[i] * B[ind[i]]
  IRADD / IRSCP                 indirect, random strides (mean k)

The index generators are numpy, identical to the reference's.  Data comes
from ``np.random.default_rng(seed)`` (the reference draws with
``jax.random``, so the two packages' numbers differ while the shapes
agree).  Every timing goes through a timer of ``testing.timing``; the
default is the CUDA-event timer, which needs the card.

``stream_triad_bandwidth`` measures the card through the STREAM-triad
kernel (``kernels.gather_bench.stream_triad``) and ``card_chip`` turns that
into the ``ChipSpec`` the balance model predicts with -- the counterpart of
the reference benchmarks' ``host_chip``, which ``host_chip`` is on the host
(its plain triad on the host clock).  ``run_gather_split`` is the Fig.
2/3b dense-vs-indirect split through the triad and ``gather_scp`` kernels.
``time_fn`` is the reference's best / mean wall-clock helper.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import gather_bench as GB
from ..testing.timing import CudaEventTimer, WallTimer
from ..utils.hw import H100, ChipSpec, default_device, synchronize

# ---------------------------------------------------------------------------
# index-vector generators (the paper's stride distributions)
# ---------------------------------------------------------------------------


def ind_constant_stride(n_access: int, k: int, n_b: int) -> np.ndarray:
    """IS: ind(i) = k*i, clipped to the B length (monotonic, regular)."""
    idx = (np.arange(n_access, dtype=np.int64) * k) % max(1, n_b)
    return idx.astype(np.int32)


def ind_random_bernoulli(n_b: int, k: float, seed: int = 0) -> np.ndarray:
    """IR: positions of Bernoulli(p=1/k) hits over [0, n_b) -- mean stride k,
    variance k(k-1) (geometric gaps)."""
    rng = np.random.default_rng(seed)
    keep = rng.random(n_b) < (1.0 / max(1.0, k))
    idx = np.nonzero(keep)[0]
    if idx.size == 0:
        idx = np.asarray([0])
    return idx.astype(np.int32)


def ind_gaussian(n_access: int, mean: float, var: float, n_b: int, seed: int = 0) -> np.ndarray:
    """Fig. 4: strides ~ N(mean, var), rounded; cumulative positions wrapped
    into [0, n_b).  Negative strides (backward jumps) occur when var is large
    enough relative to mean."""
    rng = np.random.default_rng(seed)
    strides = np.rint(rng.normal(mean, np.sqrt(max(0.0, var)), size=n_access)).astype(np.int64)
    pos = np.cumsum(strides)
    pos = np.mod(pos, n_b)
    return pos.astype(np.int32)


def stride_stats(ind: np.ndarray) -> dict:
    d = np.diff(ind.astype(np.int64))
    return {
        "mean_stride": float(np.abs(d).mean()) if d.size else 0.0,
        "var_stride": float(d.var()) if d.size else 0.0,
        "frac_backward": float((d < 0).mean()) if d.size else 0.0,
        "n_access": int(ind.size),
    }


# ---------------------------------------------------------------------------
# the Table-1 kernels
# ---------------------------------------------------------------------------


def pdadd(B):
    return torch.sum(B)


def pdscp(A, B):
    return torch.dot(A, B)


def csscp(A, Bs):
    """constant-stride: the caller pre-strides B (B[::k])."""
    return torch.dot(A, Bs)


def isadd(B, ind):
    return torch.sum(B.index_select(0, ind))


def isscp(A, B, ind):
    return torch.dot(A, B.index_select(0, ind))


# IR kernels are the same code as IS; only the index distribution differs.
iradd = isadd
irscp = isscp


# ---------------------------------------------------------------------------
# timing harness
# ---------------------------------------------------------------------------


@dataclass
class BenchResult:
    name: str
    n_elements: int
    best_s: float
    mean_s: float
    bytes_moved: float           # model-side traffic (for BW derivation)
    gbytes_per_s: float
    ns_per_element: float
    cycles_per_element_1ghz: float

    def row(self) -> str:
        return (f"{self.name},{self.n_elements},{self.best_s:.3e},"
                f"{self.gbytes_per_s:.2f},{self.ns_per_element:.2f}")


def time_fn(fn, *args, repeats: int = 7, inner: int = 3) -> tuple[float, float]:
    """Best/mean wall seconds of ``fn(*args)`` after one warm-up call; the
    devices of the tensors in and out are synchronized after each inner
    loop (PyTorch runs eagerly: no ``jit`` step)."""
    out = fn(*args)
    devices = {t.device for t in (*args, out) if isinstance(t, torch.Tensor)}

    def fence():
        for d in devices:
            synchronize(d)

    fence()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(*args)
        fence()
        times.append((time.perf_counter() - t0) / inner)
    return min(times), float(np.mean(times))


def bench(name: str, fn, args, n_elements: int, bytes_moved: float,
          timer=None, iters: int = 10) -> BenchResult:
    """Time ``fn(*args)`` with ``timer`` (default: CUDA events): the best and
    the mean of its repeats."""
    timer = timer if timer is not None else CudaEventTimer()
    times = timer.measure_all(fn, args, key=name, iters=iters)
    best = min(times)
    per_element = best / max(1, n_elements)
    return BenchResult(name=name, n_elements=n_elements, best_s=best,
                       mean_s=float(np.mean(times)), bytes_moved=bytes_moved,
                       gbytes_per_s=bytes_moved / best / 1e9,
                       ns_per_element=per_element * 1e9,
                       cycles_per_element_1ghz=per_element * 1e9)


def _normal(rng, n: int, dtype, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(n)).to(device, dtype)


def run_table1(n: int = 1 << 22, k: int = 8, dtype=torch.float32, seed: int = 0,
               device=None, timer=None) -> list[BenchResult]:
    """All Table-1 kernels at one stride k.  ``n`` = accesses per kernel;
    B is sized n*k so strided variants don't wrap."""
    dev = default_device(device)
    vb = torch.empty(0, dtype=dtype).element_size()
    rng = np.random.default_rng(seed)
    A = _normal(rng, n, dtype, dev)
    n_b = n * k
    B = _normal(rng, n_b, dtype, dev)
    ind_is = torch.from_numpy(ind_constant_stride(n, k, n_b)).to(dev)
    ind_ir_np = ind_random_bernoulli(n_b, k, seed)[:n]  # Bernoulli count ~ n+-sqrt(n)
    A_ir = A[: ind_ir_np.size]
    ind_ir = torch.from_numpy(ind_ir_np).to(dev)
    Bs = B[::k][:n].contiguous()
    nir = int(ind_ir_np.size)
    return [
        bench("PDADD", pdadd, (B[:n],), n, n * vb, timer),
        bench("PDSCP", pdscp, (A, B[:n]), n, 2 * n * vb, timer),
        bench(f"CSSCP_k{k}", csscp, (A, Bs), n, n * vb + n * k * vb, timer),
        bench(f"ISADD_k{k}", isadd, (B, ind_is), n, n * (vb + 4), timer),
        bench(f"ISSCP_k{k}", isscp, (A, B, ind_is), n, n * (2 * vb + 4), timer),
        bench(f"IRADD_k{k}", iradd, (B, ind_ir), nir, nir * (vb + 4), timer),
        bench(f"IRSCP_k{k}", irscp, (A_ir, B, ind_ir), nir, nir * (2 * vb + 4), timer),
    ]


def run_stride_sweep(strides, n: int = 1 << 20, dtype=torch.float32, seed: int = 0,
                     kind: str = "is", device=None, timer=None) -> list[BenchResult]:
    """Fig. 3a: ISSCP/IRSCP performance vs stride."""
    dev = default_device(device)
    vb = torch.empty(0, dtype=dtype).element_size()
    out = []
    for k in strides:
        rng = np.random.default_rng(seed)
        n_b = int(n * max(1, k))
        B = _normal(rng, n_b, dtype, dev)
        if kind == "is":
            ind_np = ind_constant_stride(n, int(k), n_b)
        else:
            ind_np = ind_random_bernoulli(n_b, k, seed)
        A = _normal(rng, ind_np.size, dtype, dev)
        na = int(ind_np.size)
        out.append(bench(f"{kind.upper()}SCP_k{k}", isscp,
                         (A, B, torch.from_numpy(ind_np).to(dev)), na,
                         na * (2 * vb + 4), timer))
    return out


def run_gaussian_grid(means, variances, n: int = 1 << 18, dtype=torch.float32,
                      seed: int = 0, device=None,
                      timer=None) -> list[tuple[float, float, BenchResult]]:
    """Fig. 4: IRSCP over a (mean, variance) grid of Gaussian strides."""
    dev = default_device(device)
    vb = torch.empty(0, dtype=dtype).element_size()
    out = []
    for m in means:
        for v in variances:
            rng = np.random.default_rng(seed)
            n_b = int(n * max(1.0, m))
            B = _normal(rng, n_b, dtype, dev)
            ind = torch.from_numpy(ind_gaussian(n, m, v, n_b, seed)).to(dev)
            A = _normal(rng, n, dtype, dev)
            out.append((m, v, bench(f"GAUSS_m{m}_v{v}", isscp, (A, B, ind), n,
                                    n * (2 * vb + 4), timer)))
    return out


# ---------------------------------------------------------------------------
# the dense-vs-indirect split through the two kernels, and the calibration
# ---------------------------------------------------------------------------


def run_gather_split(n: int = 1 << 22, strides=(1, 8), bernoulli_k: float = 8,
                     dtype=torch.float32, seed: int = 0, device=None,
                     timer=None) -> list[BenchResult]:
    """Fig. 2/3b: the triad against ``gather_scp`` (and the sum of its
    output) at constant strides ``strides`` and at Bernoulli indices of mean
    stride ``bernoulli_k``, all with ``n`` accesses.  Bytes are the
    streamed traffic of ``gather_bench.traffic_model`` (x apart), so
    ns/element compare the kernels' per-element cost directly."""
    dev = default_device(device)
    vb = torch.empty(0, dtype=dtype).element_size()
    rng = np.random.default_rng(seed)
    a, b, c = (_normal(rng, n, dtype, dev) for _ in range(3))
    tm = GB.traffic_model(n, vb)
    out = [bench("TRIAD", GB.stream_triad, (a, b, c), n, tm["stream_triad"], timer)]
    cases = [(f"IS_k{k}", ind_constant_stride(n, int(k), n * int(k)), n * int(k))
             for k in strides]
    n_b = int(n * bernoulli_k)
    cases.append((f"IR_k{bernoulli_k:g}", ind_random_bernoulli(n_b, bernoulli_k, seed)[:n],
                  n_b))
    for name, ind_np, n_x in cases:
        m = int(ind_np.size)
        x = _normal(rng, n_x, dtype, dev)
        idx = torch.from_numpy(ind_np).to(dev)
        am = a[:m]
        out.append(bench(f"GATHER_{name}", lambda am, idx, x: torch.sum(
            GB.gather_scp(am, idx, x)), (am, idx, x), m,
            GB.traffic_model(m, vb)["gather_scp"], timer))
    return out


def stream_triad_bandwidth(n: int = 1 << 26, dtype=torch.float32, device=None,
                           timer=None, iters: int = 10) -> float:
    """Measured ``o = b + a*c`` bandwidth of the card in bytes/s, through
    the STREAM-triad kernel: 4 n values moved per call (a, b, c read, o
    written; no write-allocate on the GPU), best of the timer's repeats."""
    dev = default_device(device)
    rng = np.random.default_rng(0)
    a, b, c = (_normal(rng, n, dtype, dev) for _ in range(3))
    vb = torch.empty(0, dtype=dtype).element_size()
    r = bench("TRIAD", GB.stream_triad, (a, b, c), n, 4 * n * vb, timer, iters)
    return r.bytes_moved / r.best_s


_CAL: dict = {}


def host_chip() -> ChipSpec:
    """A ``ChipSpec`` for this host with its STREAM-triad bandwidth measured
    on the host clock (f32, 2^24 per array; once per process) -- the
    counterpart of the reference benchmarks' ``host_chip``, with its peaks
    (bf16 1e12, f32 5e11; f64 the f32 peak, as the CPU presets set it),
    priced in the ``cpu`` family."""
    if "host" not in _CAL:
        bw = stream_triad_bandwidth(1 << 24, device="cpu", timer=WallTimer(repeats=5),
                                    iters=1)
        _CAL["host"] = ChipSpec(name="host_cpu", peak_flops_fp32=5e11, peak_flops_fp64=5e11,
                                hbm_bytes_per_s=bw, measured=True, peak_flops_bf16=1e12,
                                hbm_bytes=8 << 30)
    return _CAL["host"]


def card_chip(device=None, n: int = 1 << 26) -> ChipSpec:
    """The H100 ``ChipSpec`` with the card's measured STREAM-triad bandwidth
    (f32, ``n`` per array; measured once per process and device)."""
    dev = default_device(device)
    key = (str(dev), n)
    if key not in _CAL:
        _CAL[key] = H100.with_bandwidth(stream_triad_bandwidth(n, device=dev))
    return _CAL[key]
