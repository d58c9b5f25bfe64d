"""Run one cell of the benchmark of ``repro_torch`` and print its result.

    python3 -m spmvbench.run --workload hmep.spmv --seed 7 --seconds 10 --trace 0

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``;
its configuration in ``spmvbench/configs/<config>.json``, whose ``generator``
names the module in ``spmvbench/generators/`` that makes its matrix and
plain reference; its traffic mix in
``spmvbench/traffic/<traffic>.json``, whose ``driver`` names the general
driver in ``spmvbench/drivers/``; the limits of its correctness check in
``spmvbench/limits/<cell>.json``; and each metric's reader in
``spmvbench/metrics/<metric>.py`` (or, for ``name.suffix``, in
``<name>.py``).  Adding a cell adds files and entries and edits none.

A run is one process: set-up (imports, the kernel libraries, the matrix
from ``--seed``, the plan, warm-up of the cell's own shapes), the window of
``--seconds``, then the check of what the window produced against the plain
reference, and one JSON line, the last on standard output.  With
``--trace 1`` the first seconds of the window are profiled and the line
carries the per-layer metrics, ``busy_s``, ``window_s`` and ``breakdown``;
with ``--trace 0`` it carries the end-to-end metrics.  Without a card the
run prints no result and exits with 2.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
#: top-level module names that may not be loaded in a run: JAX and the JAX
#: package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was loaded."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def use_checkout_paths() -> None:
    """Caches inside the checkout at fixed paths; the program from ``src``."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str) -> tuple[dict, dict]:
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    return bench, cells[name]


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def metric_reader(name: str):
    """``metrics/<name>.py``, else ``metrics/<name before the first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"spmvbench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} in {HERE / 'metrics'}")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


class Bench:
    """What a driver gets: the cell's files, the seed, the device, the
    matrix as the benchmark made it, and the set-up clock."""

    def __init__(self, cell: str, config: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, device, out=print):
        import numpy as np
        import torch

        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.out = out
        self.phases: dict[str, float] = {}
        self.value_dtype = config["value_dtype"]
        self.vector_dtype = traffic.get("vector_dtype", config["vector_dtype"])
        self.format = traffic.get("format", config["format"])
        self._np = np
        self._torch = torch
        self.matrix = None

    def subseed(self, k: int) -> int:
        """The k-th independent 63-bit seed drawn from the run's seed."""
        ss = self._np.random.SeedSequence([self.seed % (1 << 64), k])
        return int(ss.generate_state(1, self._np.uint64)[0] >> 1)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def torch_dtype(self, name: str):
        return getattr(self._torch, name)

    def build_matrix(self) -> None:
        """The configuration's generator's :class:`generators.Matrix`, from
        its ``params`` (and sub-seed 0 where it is ``seeded``)."""
        params = dict(self.config["params"])
        if self.config.get("seeded"):
            params["seed"] = self.subseed(0)
        dtype = self._np.dtype(self.value_dtype)
        m = load_generator(self.config["generator"]).build(params, dtype.type)
        if m.csr is not None and m.csr[2].dtype != dtype:
            raise ValueError(f"generator made {m.csr[2].dtype}, the configuration states "
                             f"{self.value_dtype}")
        self.matrix = m
        self.n, self.nnz, self.n_diag = m.n, m.nnz, m.n_diag

    def program_matrix(self):
        """The program's CSR, from copies of the benchmark's arrays."""
        from repro_torch.core.formats import CSR

        if self.matrix.csr is None:
            raise ValueError(
                f"the generator {self.config['generator']!r} of this configuration hands "
                f"over no CSR: its cell's driver builds the program's operator from the "
                f"configuration's params (as drivers/lanczos_operator.py does)")
        row_ptr, col, val = self.matrix.csr
        return CSR(row_ptr.copy(), col.copy(), val.copy(), (self.n, self.n))

    def plan_config(self):
        from repro_torch.core.planconfig import PlanConfig

        return PlanConfig(format=self.format, device=self.device)

    def reference(self):
        return self.matrix.reference(self.device)

    def pool(self, k: int, count: int, dtype: str):
        """``count`` seeded vectors of length n on the device, drawn there."""
        g = self._torch.Generator(device=self.device).manual_seed(self.subseed(k))
        return self._torch.randn((count, self.n), generator=g, device=self.device,
                                 dtype=self.torch_dtype(dtype))

    def spmv_bytes(self, columns: int = 1) -> int:
        from . import counts

        return counts.spmv_bytes(self.n, self.nnz, self.n_diag, self.config["values"],
                                 self.value_dtype, self.vector_dtype, columns)

    def value_bytes(self) -> int:
        return self.spmv_bytes(0)

    def compute_dtype(self) -> str:
        return "float64" if "float64" in (self.value_dtype, self.vector_dtype) else "float32"


def load_generator(name: str):
    """``generators/<name>.py``, the module whose ``build(params, dtype)``
    makes a configuration's matrix."""
    path = HERE / "generators" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no generator {name!r}: spmvbench/generators/{name}.py "
                                f"does not exist")
    return importlib.import_module(f"spmvbench.generators.{name}")


def load_driver(traffic: dict):
    return importlib.import_module(f"spmvbench.drivers.{traffic['driver']}")


def check_numbers(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit: correct when every one is at most its
    limit (NaN fails).  Empty ``limits`` (calibration) hold nothing."""
    if limits and set(limits) != set(numbers):
        raise KeyError(f"the check gave {sorted(numbers)}, the limits are for {sorted(limits)}")
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]["limit"] if limits else float("inf")
        ok &= value == value and value <= limit
        out[name] = {"value": value, "limit": limit}
    return ok, out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda", *,
             bench: dict | None = None, config: dict | None = None,
             traffic: dict | None = None, limits: dict | None = None, out=print) -> dict:
    """Set up, measure and check one cell; returns the result's dict.  The
    keyword arguments replace the files found by name (the tests run tiny
    configurations on the host this way)."""
    import torch

    if bench is None:
        bench, entry = find_cell(cell)
    else:
        entry = {c["name"]: c for c in bench["workloads"]}[cell]
    config = config or load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = traffic or load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    if limits is None:
        limits = load_json(HERE / "limits" / f"{cell}.json")
    b = Bench(cell, config, traffic, seed, seconds, trace, device, out)
    b.phases["import"] = time.perf_counter() - T_IMPORT
    with b.phase("import"):
        import repro_torch  # noqa: F401
        from repro_torch.kernels import cuda_build
    if b.device.type == "cuda":
        with b.phase("kernels"):
            cuda_build.build_kernels()
    with b.phase("matrix"):
        b.build_matrix()
    out(f"[setup] {cell}: n={b.n} nnz={b.nnz} diagonal nonzeros={b.n_diag} "
        f"values={b.value_dtype} vectors={b.vector_dtype} format={b.format}")
    driver = load_driver(traffic)
    state = driver.setup(b)
    if trace:
        from .trace import warm_profiler
        with b.phase("profiler"):
            warm_profiler(b.device)
    # what set-up made (the imports, the matrix, the plan) is frozen out of
    # the collector's full passes, which would otherwise scan it at a
    # moment no run controls and stall the window for some 100 ms
    gc.collect()
    gc.freeze()
    setup_s = process_age_s()
    out("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in b.phases.items())
        + f"; setup_s {setup_s:.3f}")
    cuda_build.reset_launch_counts()
    result = driver.window(b, state)
    peak = int(torch.cuda.max_memory_allocated(b.device)) if b.device.type == "cuda" else 0
    launches = {k: v for k, v in cuda_build.launch_counts().items() if v}
    out(f"[window] {result['summary']}; launches {launches}")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded in the run: {bad}")
    del state
    samples = result.pop("samples")
    if b.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, checks = check_numbers(driver.check(b, samples), limits)
    out(f"[check] reference in {time.perf_counter() - t_check:.3f} s: correct={correct}")

    # what a metric's reader gets: the cell, the window's record and, in a
    # traced run, the counters and device time of its profiled stretch
    ctx = types.SimpleNamespace(bench=b, result=result, setup_s=setup_s,
                                traced=result.get("traced"), trace=result.get("trace"))
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if b.device.type == "cuda" else b.device.type,
           "kind": (torch.cuda.get_device_name(b.device) if b.device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    line = {"correct": bool(correct), "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": metrics, "device": dev}
    if trace and ctx.trace:
        dev["busy_s"] = ctx.trace["busy_s"]
        dev["window_s"] = ctx.trace["window_s"]
        top = sorted(ctx.trace["ops_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(ctx.trace["idle_s"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k[:160], v] for k, v in top],
                             "idle_gaps": [[k, v] for k, v in gaps]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_paths()
    bench, entry = find_cell(args.workload)
    import torch

    want = int(entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"spmvbench: needs {want} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"[card] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    bench=bench, out=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"spmvbench: loaded in the run: {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
