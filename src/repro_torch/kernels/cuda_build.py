"""Build, load, launch and count the hand-written CUDA kernels of ``csrc/``.

Each source ``csrc/<source>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface and loaded with ``ctypes``;
a source holds one kernel's C entry point, or several (``gather_bench.cu``
holds ``stream_triad`` and ``gather_scp``): nine sources, ten kernels.  A
tenth source, ``plan_launch.cu``, holds no kernel of its own: its entry
point ``plan_spmv`` launches kernels 2 and 1 from a launch record
(``kernels/plan_launch.py``), which counts them under their own names.
The build runs at first use -- one ``nvcc`` per source, all started
together -- into ``build/kernels/`` at
the repository root (git-ignored).  A library's file name carries a hash of
its source and flags, so an edited kernel is rebuilt and an unchanged one is
loaded as it is.

Every kernel module launches through :func:`launch`, and no other module
looks up an entry point or a stream: it passes the device's current stream,
enters the device where it is not current, raises on the entry point's
return code (:func:`raise_on_error`, one convention for every entry point)
and adds one to the launch counters under each name it is given, so a run
can show that its main path went through the kernels.  The grouped GEMM,
the BELL SpMM and the matrix-free SpMV also count the path that ran
(``PATH_COUNTERS``).  All of it
is one ``kernel.launch`` span (``utils.spans``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..utils.spans import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: source (``csrc/<source>.cu``, one shared library each) -> the C entry
#: points it defines; each entry point is a kernel with its own launch count
SOURCES = {"sell_spmv": ("sell_spmv",), "dia_spmv": ("dia_spmv",),
           "csr_spmv": ("csr_spmv",), "mf_spmv": ("mf_spmv",),
           "sell_spmm": ("sell_spmm",),
           "gather_bench": ("stream_triad", "gather_scp"),
           "bell_spmm": ("bell_spmm",), "grouped_gemm": ("grouped_gemm",),
           "mf_product": ("mf_product",), "plan_launch": ()}
KERNELS = tuple(k for names in SOURCES.values() for k in names)
#: C entry points that launch other sources' kernels -> their source; the
#: kernels they launch are counted, not the entry point
LAUNCHERS = {"plan_spmv": "plan_launch"}
SOURCE_OF = {k: src for src, names in SOURCES.items() for k in names} | LAUNCHERS
#: kernels whose entry point runs on several paths (two CUDA kernels, or
#: one kernel's instantiations: BELL's decode and wide, kernel 4's lanes
#: read as codes or streamed): a launch counts under the entry point and
#: under the path that ran
PATH_COUNTERS = ("grouped_gemm_wgmma", "grouped_gemm_simt", "bell_spmm_decode",
                 "bell_spmm_wide", "mf_spmv_coded", "mf_spmv_streamed")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              # separate multiply and add, as the plain PyTorch versions do
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

#: value-storage dtype -> the code the C entry points dispatch on
VALUE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2,
               torch.float16: 3, torch.float8_e4m3fn: 4, torch.int8: 5}
#: ``kTensorMapError`` of grouped_gemm.cu: a return code at or above it is a
#: failed ``cuTensorMapEncodeTiled``, its ``CUresult`` added
TENSOR_MAP_ERROR = 1 << 20

_LAUNCHES = {name: 0 for name in KERNELS + PATH_COUNTERS}
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, object] = {}
_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (kernel -> launches; negative takes launches back) to
    the counters: a CUDA graph's replay adds the launches its capture
    counted, and the capture takes back its own."""
    for name, k in counts.items():
        _LAUNCHES[name] += k


def launch_counts() -> dict:
    """Copy of the per-kernel launch counters."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def nvcc_path() -> str:
    """The ``nvcc`` to build with: on ``PATH``, else under ``$CUDA_HOME``
    or ``/usr/local/cuda``.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin: "
        "the CUDA kernels in repro_torch/csrc are built with nvcc at first use")


def source_path(name: str) -> Path:
    """The ``.cu`` file of a kernel (or of a source) name."""
    return CSRC / f"{SOURCE_OF.get(name, name)}.cu"


def library_path(name: str) -> Path:
    """Where the library of ``name`` (a kernel or its source) lands: hashed
    over its source, the shared header and the flags."""
    src = SOURCE_OF.get(name, name)
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in [source_path(src)] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{src}-{h.hexdigest()[:12]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(source_path(name))]


def build_kernels(names=tuple(SOURCES)) -> dict[str, Path]:
    """Compile every library (one per source) that is not built yet, all
    ``nvcc`` runs in parallel; the compiler's ``-Xptxas -v`` report goes to
    ``<lib>.log``.  Raises ``RuntimeError`` with the compiler's output on a
    failed build.  Returns {source: library path}."""
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's report (registers, spills) for ``name``'s library."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def kernel_function(name: str, argtypes: list):
    """The C entry point ``name`` of its library, built and loaded on first
    use (every kernel library is built then, in parallel)."""
    fn = _FNS.get(name)
    if fn is None:
        with _LOCK:
            src = SOURCE_OF[name]
            if src not in _LIBS:
                for n, p in build_kernels().items():
                    _LIBS.setdefault(n, ctypes.CDLL(str(p)))
            fn = getattr(_LIBS[src], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn
    return fn


# ---------------------------------------------------------------------------
# wrapper helpers
# ---------------------------------------------------------------------------


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def check_tensor(t: torch.Tensor, what: str, device: torch.device,
                 dtypes=None, ndim: int | None = None) -> None:
    """Raise unless ``t`` lies on ``device``, is contiguous and has one of
    ``dtypes`` and ``ndim`` dimensions."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what} has {t.dim()} dimensions, expected {ndim}")


def value_code(t: torch.Tensor, what: str) -> int:
    try:
        return VALUE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{what}: value dtype {t.dtype} has no CUDA kernel "
                        f"(supported: {list(VALUE_CODES)})") from None


def raise_on_error(name: str, rc: int) -> None:
    """Raise on an entry point's non-zero return code: a ``cudaError_t``, or
    ``TENSOR_MAP_ERROR`` plus the ``CUresult`` of a failed
    ``cuTensorMapEncodeTiled``."""
    if rc >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with CUresult "
                           f"{rc - TENSOR_MAP_ERROR}")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc} "
                           "(cudaGetLastError after the launch)")


def launch(name: str, argtypes: list, device: torch.device, *args,
           counts: tuple[str, ...] | None = None) -> None:
    """Launch the C entry point ``name`` (``kernel_function``) on ``device``
    (a CUDA device with its index) with ``args`` and, last, the device's
    current stream, the capturing one under graph capture; raise on a failed
    launch, else count one launch under each name of ``counts`` (default
    ``(name,)``).  All of it is one ``kernel.launch`` span of
    ``len(counts)``."""
    counts = (name,) if counts is None else counts
    with span("kernel.launch", n=len(counts)):
        fn = kernel_function(name, argtypes)
        index = device.index
        # the handle alone: ``current_stream(device).cuda_stream`` builds a
        # Stream object (5.2 against 0.13 us a call on an H100's host)
        stream = torch._C._cuda_getCurrentRawStream(index)
        if torch.cuda.current_device() == index:
            rc = fn(*args, stream)
        else:
            with torch.cuda.device(index):
                rc = fn(*args, stream)
        raise_on_error(name, rc)
        for c in counts:
            count_launch(c)
