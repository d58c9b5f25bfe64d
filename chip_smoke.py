#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--n 1201200] [--out chiprun_out/chip_smoke.json]

Builds the four hand-written CUDA kernels of ``src/repro_torch/csrc`` and
drives the port's main path at the paper's size:

1. the card's name and power limit, and the kernel build time;
2. every kernel at the main path's shapes against its plain PyTorch version
   on the same inputs (f64 and f32 accumulation, every value dtype), with
   CUDA-event times of the kernel, the plain version and the cuSPARSE
   yardstick (``torch.sparse_csr_tensor @ x``), beside the bound;
3. the main path: the N = 1,201,200 Holstein-Hubbard surrogate split into
   DIA + SELL, compiled into a plan, and 64 Lanczos steps on the card --
   the DIA and SELL launch counters must rise once per SpMV, and the
   recurrence must match a Lanczos run through the plain ``torch`` entry;
4. exact physics through the matrix-free kernel in f64 (E0 of the L = 4
   Holstein-Hubbard chain against dense ``eigvalsh``), and Lanczos through a
   ``csr`` plan and the CSR kernel.

It prints a ``kernels`` JSON line before the last line and ends with
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero; without CUDA, or without the repository beside it, it
prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

#: kernel-vs-plain tolerance on max|diff| / max|plain|: both sides sum the
#: same products in another order (rounding of one accumulator type)
TOL = {"float32": 1e-5, "float64": 1e-12}

VALUE_DTYPES = ("f64", "f32", "bf16", "f16", "fp8_e4m3", "int8")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 25) -> float:
    """Median device time of one call, from CUDA events around each of
    ``reps`` calls queued behind a spin kernel (so host overhead does not
    open gaps on the device between them)."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def rel_err(torch, a, b) -> tuple[float, float]:
    """(max|a - b|, max|a - b| / max|b|), both in f64."""
    a, b = a.double(), b.double()
    err = float((a - b).abs().max())
    return err, err / max(1e-300, float(b.abs().max()))


def bound_ms(chip, nbytes: int, flops: int, acc: str) -> tuple[float, str]:
    """The least time of the work on ``chip`` (a data-sheet ChipSpec): bytes
    over the memory rate or operations over the peak of ``acc``, whichever
    is larger."""
    peak = chip.peak_flops_fp64 if acc == "float64" else chip.peak_flops_fp32
    t_bytes = nbytes / chip.hbm_bytes_per_s * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts if t is not None))


def csr_tensor(torch, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               shape, device):
    """A row-sorted COO triple as a torch sparse CSR tensor (f64 values)."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    rp = np.zeros(shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=shape[0]), out=rp[1:])
    return torch.sparse_csr_tensor(
        torch.from_numpy(rp), torch.from_numpy(cols.astype(np.int64)),
        torch.from_numpy(vals.astype(np.float64)), size=tuple(shape)).to(device)


def dia_triplets(F, dia):
    data = F._np(dia.data).astype(np.float64)
    n, ncols = dia.shape
    rows, cols, vals = [], [], []
    for k, off in enumerate(F._np(dia.offsets).tolist()):
        i = np.arange(max(0, -off), min(n, ncols - off))
        keep = data[k, i] != 0
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(data[k, i[keep]])
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def sell_triplets(F, s):
    cp, cw = F._np(s.chunk_ptr), F._np(s.chunk_width)
    col, val, perm = F._np(s.col_idx), F._np(s.val).astype(np.float64), F._np(s.perm)
    chunk_of = np.repeat(np.arange(s.n_chunks), cw.astype(np.int64) * s.C)
    pos = np.arange(col.shape[0]) - cp[chunk_of]
    rows = perm[chunk_of * s.C + pos % s.C].astype(np.int64)
    keep = (val != 0) & (rows < s.shape[0])
    return rows[keep], col[keep].astype(np.int64), val[keep]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_201_200,
                    help="surrogate rows (the paper's N = 1,201,200)")
    ap.add_argument("--lanczos-steps", type=int, default=64)
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "chip_smoke.json"))
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    try:
        from repro_torch.core import formats as F
        from repro_torch.core import matrices as M
        from repro_torch.core.eigensolver import lanczos
        from repro_torch.core.plan import SpMVPlan
        from repro_torch.core.planconfig import PlanConfig
        from repro_torch.kernels import cuda_build as CB
        from repro_torch.kernels import csr, csr_spmv, dia, dia_spmv, matrix_free
        from repro_torch.kernels import sell, sell_spmv
        from repro_torch.utils.hw import H100
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this script "
              f"({e})", file=sys.stderr)
        return 3

    # torch.sparse_csr_tensor (the cuSPARSE yardstick) warns that it is beta
    warnings.filterwarnings("ignore", message=".*[Ss]parse.*")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {smi}")
    out = {"card": smi, "device": kind}
    rows = {}  # kernel name -> its entry of the closing "kernels" line

    def record(name, **kw):
        rows.setdefault(name, {"name": name}).update(kw)

    # --- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    CB.build_kernels()
    out["build_s"] = time.perf_counter() - t0
    log(f"[build] 4 kernel libraries in {out['build_s']:.1f} s (nvcc, sm_90a)")
    for name in CB.KERNELS:
        regs = [ln.strip() for ln in CB.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln and "0 bytes" not in ln]
        log(f"[ptxas] {name}: " + ("; ".join(regs[:2]) if regs else "(cached build)"))

    # --- matrices, built once -------------------------------------------------
    t0 = time.perf_counter()
    m = M.holstein_hubbard_surrogate(args.n, seed=0)
    hyb = F.split_dia(m)
    sell128 = F.SELL.from_csr(m, C=128)
    lap_csr = M.laplacian_2d(1100, 1100)
    lap = F.MatrixFreeOperator.from_csr(lap_csr)
    exact_csr = M.holstein_hubbard_exact()
    exact = F.MatrixFreeOperator.from_csr(exact_csr)
    out["host_prep_s"] = time.perf_counter() - t0
    log(f"[matrices] surrogate N={m.shape[0]} nnz={m.nnz}; DIA part "
        f"{hyb.dia.offsets.shape[0]} diagonals, SELL rest nnz={hyb.rest.nnz} "
        f"({hyb.rest.n_chunks} chunks of C={hyb.rest.C}); laplacian "
        f"{lap.shape[0]} rows, {lap.n_generated} generated diagonals; exact "
        f"L=4 dim {exact.shape[0]} ({exact.n_stored} stored, {exact.n_generated} "
        f"generated lanes); host preprocessing {out['host_prep_s']:.1f} s")

    rng = np.random.default_rng(0)
    x64 = torch.from_numpy(rng.standard_normal(args.n)).to(dev)
    on = lambda t: None if t is None else t.to(dev)  # noqa: E731
    checks = []

    def compare(name, what, got, want):
        acc = str(want.dtype).replace("torch.", "")
        err, rel = rel_err(torch, got, want)
        ok = bool(torch.isfinite(got).all()) and rel <= TOL[acc]
        checks.append({"kernel": name, "case": what, "acc": acc,
                       "max_abs_err": err, "rel_err": rel, "ok": ok})
        log(f"[check] {name:9s} {what:34s} acc={acc:7s} rel err {rel:.3e}")
        check(ok, f"{name} {what}: kernel disagrees with its plain version "
                  f"(rel err {rel:.3e} > {TOL[acc]:g})")
        return err

    # --- 2a. SELL: the hybrid's remainder (main-path shapes) + C = 128 ------
    def sell_case(s, x, what, timed=False):
        cp, cw, col, val, scale, perm = map(on, (s.chunk_ptr, s.chunk_width,
                                                 s.col_idx, s.val, s.scale, s.perm))
        seg = on(sell.sell_segment_ids(s))
        n, C = s.shape[0], s.C
        args_ = (cp, cw, col, val, scale, perm, x, n, C)
        k = lambda: sell_spmv.sell_spmv_arrays(*args_)  # noqa: E731
        p = lambda: sell_spmv.sell_spmv_plain(*args_, seg)  # noqa: E731
        err = compare("sell_spmv", what, k(), p())
        if timed:
            acc = str(k().dtype).replace("torch.", "")
            lib = csr_tensor(torch, *sell_triplets(F, s), s.shape, dev)
            xl = x.double()
            b, by = bound_ms(H100, nbytes(cp, cw, col, val, scale, perm, x)
                             + n * x.element_size(), 2 * s.nnz, acc)
            record("sell_spmv", route="cuda", source="src/repro_torch/csrc/sell_spmv.cu",
                    replaces="src/repro/kernels/sell_spmv.py:79", max_abs_err=err,
                    ms=time_ms(torch, k), plain_ms=time_ms(torch, p), bound_ms=b,
                    bound_by=by, library_ms=time_ms(torch, lambda: lib @ xl),
                    shape=f"hybrid SELL rest, C={C}, {s.nnz} nnz, val f32, x f64")

    sell_case(hyb.rest, x64, "hybrid rest C=8 f32 val, f64 x", timed=True)
    for vd in VALUE_DTYPES:
        sv = F.with_value_dtype(hyb.rest, vd)
        x = x64 if vd == "f64" else x64.float()
        sell_case(sv, x, f"hybrid rest C=8 {vd} val, {x.dtype}".replace("torch.", ""))
    sell_case(sell128, x64.float(), "full surrogate C=128 f32 val, f32 x")

    # --- 2b. DIA: the hybrid's 13 diagonals ------------------------------------
    pad0, pad1, n = dia.dia_layout(hyb.dia)

    def dia_case(d, x, what, timed=False):
        data, offs, scale = map(on, (d.data, d.offsets, d.scale))
        idx = on(dia.dia_gather_index(d))
        acc = torch.float64 if (x.dtype == torch.float64 or data.dtype == torch.float64) \
            else torch.float32
        xp = dia_spmv.pad_x(x, pad0, pad1, acc)
        k = lambda: dia_spmv.dia_spmv_arrays(data, offs, scale, xp, pad0, n)  # noqa: E731
        p = lambda: dia_spmv.dia_spmv_plain(data, offs, scale, xp, pad0, n, idx)  # noqa: E731
        err = compare("dia_spmv", what, k(), p())
        if timed:
            lib = csr_tensor(torch, *dia_triplets(F, d), d.shape, dev)
            xl = x.double()
            b, by = bound_ms(H100, nbytes(data, offs, scale, x) + n * xp.element_size(),
                             2 * data.numel(), str(acc).replace("torch.", ""))
            record("dia_spmv", route="cuda", source="src/repro_torch/csrc/dia_spmv.cu",
                    replaces="src/repro/kernels/dia_spmv.py:63", max_abs_err=err,
                    ms=time_ms(torch, k), plain_ms=time_ms(torch, p), bound_ms=b,
                    bound_by=by, library_ms=time_ms(torch, lambda: lib @ xl),
                    shape=f"hybrid DIA part, {tuple(data.shape)} val f32, x f64")

    dia_case(hyb.dia, x64, "hybrid DIA f32 val, f64 x", timed=True)
    for vd in VALUE_DTYPES:
        dv = F.with_value_dtype(hyb.dia, vd)
        x = x64 if vd == "f64" else x64.float()
        dia_case(dv, x, f"hybrid DIA {vd} val, {x.dtype}".replace("torch.", ""))

    # --- 2c. CSR: the full surrogate -------------------------------------------
    def csr_case(c, x, what, timed=False):
        rp, col, val, scale = map(on, (c.row_ptr, c.col_idx, c.val, c.scale))
        rid = on(csr.csr_row_ids(c))
        lanes = csr_spmv.csr_lanes(c.n_rows, c.nnz)
        k = lambda: csr_spmv.csr_spmv_arrays(rp, col, val, scale, x, lanes)  # noqa: E731
        p = lambda: csr_spmv.csr_spmv_plain(rp, col, val, scale, x, rid)  # noqa: E731
        err = compare("csr_spmv", what, k(), p())
        if timed:
            acc = str(k().dtype).replace("torch.", "")
            lib = torch.sparse_csr_tensor(rp.long(), col.long(), val.double(),
                                          size=c.shape)
            xl = x.double()
            b, by = bound_ms(H100, nbytes(rp, col, val, scale, x)
                             + c.n_rows * x.element_size(), 2 * c.nnz, acc)
            record("csr_spmv", route="cuda", source="src/repro_torch/csrc/csr_spmv.cu",
                    replaces="src/repro/kernels/csr_spmv.py:73", max_abs_err=err,
                    ms=time_ms(torch, k), plain_ms=time_ms(torch, p), bound_ms=b,
                    bound_by=by, library_ms=time_ms(torch, lambda: lib @ xl),
                    shape=f"full surrogate, {c.nnz} nnz, {lanes} lanes/row, "
                          "val f32, x f64")

    csr_case(m, x64, "full surrogate f32 val, f64 x", timed=True)
    for vd in VALUE_DTYPES:
        cv = F.with_value_dtype(m, vd)
        x = x64 if vd == "f64" else x64.float()
        csr_case(cv, x, f"full surrogate {vd} val, {x.dtype}".replace("torch.", ""))

    # --- 2d. matrix-free: laplacian_2d(1100, 1100) and exact L = 4 -------------
    def mf_case(op, x, what, timed=False, lib_csr=None):
        diags = matrix_free.mf_tables(op)
        desc, gen = matrix_free.mf_pack_descriptor(diags)
        data = on(matrix_free.mf_data(op))
        desc_d, gen_d = on(desc), on(gen)
        p0, p1 = matrix_free.mf_pads(op)
        acc = torch.float64 if (x.dtype == torch.float64 or data.dtype == torch.float64) \
            else torch.float32
        xp = dia_spmv.pad_x(x, p0, p1, acc)
        nn = op.shape[0]
        k = lambda: matrix_free.mf_spmv_arrays(data, desc_d, gen_d, xp, p0, nn)  # noqa: E731
        p = lambda: matrix_free.mf_spmv_plain(data, desc, gen, xp, p0, nn)  # noqa: E731
        err = compare("mf_spmv", what, k(), p())
        if timed:
            lib = csr_tensor(torch, F._np(lib_csr.to_coo().rows).astype(np.int64),
                             F._np(lib_csr.col_idx).astype(np.int64),
                             F._np(lib_csr.val), lib_csr.shape, dev)
            xl = x.double()
            b, by = bound_ms(H100, nbytes(data, desc_d, gen_d, x) + nn * xp.element_size(),
                             2 * op.nnz, str(acc).replace("torch.", ""))
            record("mf_spmv", route="cuda", source="src/repro_torch/csrc/mf_spmv.cu",
                    replaces="src/repro/kernels/matrix_free.py:262", max_abs_err=err,
                    ms=time_ms(torch, k), plain_ms=time_ms(torch, p), bound_ms=b,
                    bound_by=by, library_ms=time_ms(torch, lambda: lib @ xl),
                    shape=f"laplacian_2d(1100, 1100), {op.n_generated} generated "
                          "diagonals, f64")

    xl64 = torch.from_numpy(rng.standard_normal(lap.shape[0])).to(dev)
    mf_case(lap, xl64, "laplacian 1100^2 f64", timed=True, lib_csr=lap_csr)
    for vd in ("f32", "bf16", "f16"):
        mf_case(F.with_value_dtype(lap, vd), xl64.float(), f"laplacian 1100^2 {vd}, f32 x")
    xe = torch.from_numpy(rng.standard_normal(exact.shape[0])).to(dev)
    mf_case(exact, xe, "holstein exact L=4 f64")
    mf_case(F.with_value_dtype(exact, "f32"), xe.float(), "holstein exact L=4 f32, f32 x")

    # --- 3. the main path: hybrid plan -> Lanczos on the card -----------------
    v0 = np.random.default_rng(1).standard_normal(args.n)
    plan = SpMVPlan.compile(hyb, PlanConfig())
    check(plan.report.kernel == "cuda", f"hybrid plan picked {plan.report.kernel}")
    def timed_lanczos(reorthogonalize: bool):
        """Lanczos through the plan, with CUDA events around each SpMV;
        returns the result, the SpMV times (ms) and the wall time (ms)."""
        events = []

        class Timed:
            device = plan.device

            def __call__(self, x):
                s, e = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                s.record()
                y = plan(x)
                e.record()
                events.append((s, e))
                return y

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = lanczos(Timed(), args.n, m=args.lanczos_steps, v0=v0,
                    reorthogonalize=reorthogonalize)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return r, [s.elapsed_time(e) for s, e in events], wall

    CB.reset_launch_counts()
    res, spmv_ms, wall_ms = timed_lanczos(True)
    counts = CB.launch_counts()
    for name in ("dia_spmv", "sell_spmv"):
        record(name, launches=counts[name], launches_per_lanczos_step=counts[name] / res.n_spmv)
        check(counts[name] == res.n_spmv,
              f"main path: {name} launched {counts[name]} times for {res.n_spmv} SpMVs")
    ref = lanczos(SpMVPlan.compile(hyb, PlanConfig(backend="torch")), args.n,
                  m=args.lanczos_steps, v0=v0)
    da = float(np.max(np.abs(res.alphas - ref.alphas) / np.maximum(1e-300, np.abs(ref.alphas))))
    db = float(np.max(np.abs(res.betas - ref.betas) / np.maximum(1e-300, np.abs(ref.betas))))
    check(res.alphas.shape == ref.alphas.shape and da <= 1e-6 and db <= 1e-6,
          f"main path: Lanczos through the kernels differs from the torch entry "
          f"(alpha {da:.2e}, beta {db:.2e})")
    # the paper's setting: plain Lanczos, no reorthogonalization
    _, spmv_ms_plain, wall_ms_plain = timed_lanczos(False)
    t_spmv = float(np.median(spmv_ms))
    main = {"n": args.n, "nnz": m.nnz, "steps": res.n_spmv, "E0": float(res.eigenvalues[0]),
            "spmv_ms_median": t_spmv, "gflops": 2 * m.nnz / (t_spmv * 1e-3) / 1e9,
            "spmv_share": float(np.sum(spmv_ms)) / wall_ms, "lanczos_wall_ms": wall_ms,
            "spmv_share_no_reorth": float(np.sum(spmv_ms_plain)) / wall_ms_plain,
            "lanczos_wall_ms_no_reorth": wall_ms_plain,
            "alpha_rel_diff_vs_torch": da, "beta_rel_diff_vs_torch": db,
            "launches": {k: counts[k] for k in ("dia_spmv", "sell_spmv")}}
    out["main_path"] = main
    log(f"[main] hybrid DIA+SELL plan (kernel={plan.report.kernel}) -> Lanczos "
        f"{res.n_spmv} steps: E0={main['E0']:.10f}; {t_spmv:.4f} ms/SpMV "
        f"({main['gflops']:.1f} GFLOP/s); SpMV share of Lanczos time "
        f"{100 * main['spmv_share']:.1f} % ({100 * main['spmv_share_no_reorth']:.1f} % "
        f"without reorthogonalization); launches dia={counts['dia_spmv']} "
        f"sell={counts['sell_spmv']}; vs torch entry: alpha {da:.1e}, beta {db:.1e}")

    # --- 4a. exact physics through the matrix-free kernel, f64 ----------------
    plan_e = SpMVPlan.compile(exact, PlanConfig())
    check(plan_e.report.kernel == "cuda", f"matrix-free plan picked {plan_e.report.kernel}")
    e_dense = float(np.linalg.eigvalsh(exact_csr.to_dense())[0])
    CB.reset_launch_counts()
    res_e = lanczos(plan_e, exact.shape[0], m=200, v0=np.random.default_rng(2)
                    .standard_normal(exact.shape[0]))
    counts = CB.launch_counts()
    record("mf_spmv", launches=counts["mf_spmv"],
            launches_per_lanczos_step=counts["mf_spmv"] / res_e.n_spmv)
    check(counts["mf_spmv"] == res_e.n_spmv,
          f"exact path: mf_spmv launched {counts['mf_spmv']} times for {res_e.n_spmv} SpMVs")
    e0 = float(res_e.eigenvalues[0])
    check(abs(e0 - e_dense) <= 1e-8 * max(1.0, abs(e_dense)),
          f"exact path: E0 {e0!r} vs dense {e_dense!r}")
    out["exact"] = {"dim": exact.shape[0], "E0": e0, "E0_dense": e_dense,
                    "steps": res_e.n_spmv, "launches": counts["mf_spmv"]}
    log(f"[exact] holstein_exact L=4 dim {exact.shape[0]} through mf_spmv (f64): "
        f"E0={e0:.12f} dense={e_dense:.12f} |diff|={abs(e0 - e_dense):.1e}; "
        f"{counts['mf_spmv']} launches")

    # --- 4b. a csr plan on the surrogate through the CSR kernel ---------------
    plan_c = SpMVPlan.compile(m, PlanConfig(format="csr"))
    check(plan_c.report.kernel == "cuda", f"csr plan picked {plan_c.report.kernel}")
    CB.reset_launch_counts()
    res_c = lanczos(plan_c, args.n, m=16, v0=v0)
    counts = CB.launch_counts()
    record("csr_spmv", launches=counts["csr_spmv"],
            launches_per_lanczos_step=counts["csr_spmv"] / res_c.n_spmv)
    check(counts["csr_spmv"] == res_c.n_spmv,
          f"csr path: csr_spmv launched {counts['csr_spmv']} times for {res_c.n_spmv} SpMVs")
    dc = float(np.max(np.abs(res_c.alphas - res.alphas[:16]) / np.abs(res.alphas[:16])))
    check(dc <= 1e-6, f"csr path: Lanczos differs from the hybrid path ({dc:.2e})")
    out["csr_path"] = {"steps": res_c.n_spmv, "launches": counts["csr_spmv"],
                       "alpha_rel_diff_vs_hybrid": dc}
    log(f"[csr] csr plan (kernel={plan_c.report.kernel}) -> Lanczos {res_c.n_spmv} "
        f"steps, {counts['csr_spmv']} launches; alphas vs hybrid path {dc:.1e}")

    # --- 5. report -------------------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: rows[n].get(k) for k in keys} for n in
               ("sell_spmv", "dia_spmv", "csr_spmv", "mf_spmv")]
    for kr in kernels:
        check(all(kr[k] is not None for k in keys), f"incomplete kernel row {kr}")
    out["kernels"] = [rows[n] for n in ("sell_spmv", "dia_spmv", "csr_spmv", "mf_spmv")]
    out["checks"] = checks
    out["wall_s"] = time.perf_counter() - t_start
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    for kr in out["kernels"]:
        log(f"[kernel] {kr['name']:9s} {kr['ms']:.4f} ms (plain {kr['plain_ms']:.4f}, "
            f"cuSPARSE {kr['library_ms']:.4f}, bound {kr['bound_ms']:.4f} by "
            f"{kr['bound_by']}); {kr['launches']} launches on its path; {kr['shape']}")
    log(f"[done] {out['wall_s']:.1f} s; card: {smi}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
