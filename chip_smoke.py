#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--n 1201200] [--out chiprun_out/chip_smoke.json]

Builds the hand-written CUDA kernels of ``src/repro_torch/csrc`` -- one
for each of the nine TPU kernels, two for the grouped GEMM (kernel 7: a
wgmma + TMA kernel for bf16, a SIMT kernel for f32), and ``mf_product``,
the generated electron x phonon Hamiltonian; nine sources, one ``nvcc``
each, in parallel -- and drives the port's paths at the paper's
size and, for the sparse-weight layer, at the widths of two models the
repository configures:

1. the card's name and power limit, the kernel build time, and the
   compiler's registers, shared memory and spills for every instantiation
   of the kernels redesigned last (SELL SpMV, STREAM triad, SELL SpMM,
   BELL SpMM);
2. every SpMV kernel at the main path's shapes against its plain PyTorch
   version on the same inputs (f64 and f32 accumulation, every value
   dtype), with CUDA-event times of the kernel, the plain version and the
   cuSPARSE yardstick (``torch.sparse_csr_tensor @ x``), beside the bound;
   the SELL kernel (on its host-checked chunk blocks) also with ``add_to``,
   two calls bit-equal, and the x bytes its gathers read; the matrix-free
   kernel (on its host-checked ``MfLaunch``, x unpadded) on
   ``laplacian_2d(1100, 1100)`` and the exact L = 6 operator (f64 and f32
   lanes), with the plan call's time beside the kernel's;
3. the main path: the N = 1,201,200 Holstein-Hubbard surrogate split into
   DIA + SELL, compiled into a plan (the SELL kernel adds its rows into the
   DIA kernel's output: bit-equal to the two outputs added), and 64 Lanczos
   steps on the card -- the DIA and SELL launch counters must rise once per
   SpMV, and the recurrence must match a Lanczos run through the plain
   ``torch`` entry;
4. exact physics through the matrix-free kernel in f64 (E0 of the L = 4
   Holstein-Hubbard chain against dense ``eigvalsh``), Lanczos through a
   ``csr`` plan and the CSR kernel, and (4c) 64 Lanczos steps on the exact
   L = 6, ``max_phonon=5`` operator (1,679,616 rows, the paper's scale)
   through ``SpMVPlan.compile(op, PlanConfig())`` and kernel 4: one launch
   an SpMV, the recurrence against the ``torch`` entry's, E0 against a
   ``csr`` plan's, and a profiler line of the plan call (one kernel, no
   pad copy); (4d) the generated electron x phonon kernel ``mf_product``
   on the exact HMeP (``HMEP_EXACT``: N = 1,201,200) against its composite
   version (bit for bit) and cuSPARSE on the stored CSR, timed beside them,
   the stored ``csr`` plan and its x + y bound, 64 Lanczos steps through
   its plan (one launch an SpMV, E0 against the ``csr`` plan's), and on
   4c's exact L = 6 operator against kernel 4;
5. the STREAM calibration: the triad kernel against its plain version (bit
   for bit) and ``torch.addcmul`` (f32, f64, 2^26 per array, both timed),
   then ``card_chip()`` --
   the card's measured bandwidth, which must stay within 1.05x the data
   sheet's 3.35 TB/s;
6. the microbenchmarks: Table 1 (n = 2^22, k = 8) and the dense-vs-indirect
   split through the triad and gather kernels (ns/element);
7. the model: ``select_format`` on ``card_chip()`` and a
   ``PlanConfig(format="auto")`` plan for four matrices and three held out
   of the efficiency fit (the exact L = 6 operator among them), every
   candidate format's plan timed, the achieved efficiency per format; a
   plan priced for another chip must run the same kernel;
8. batched SpMV: ``plan.spmm(X)`` of the surrogate's SELL plan through the
   SELL SpMM kernel (chunks in the plan's cached original-row schedule) at
   K = 1 .. 64, against its plain version, two calls bit-equal, with the
   plain and cuSPARSE SpMM times, the bound, the X gather bytes and their
   rate, and ``select_batch_width``'s curve; then the kernel against its
   plain version for every value dtype at K = 16, with f64 and f32 X;
9. sparse weights: (a) ``SparseLinear`` at Gemma-7B FFN width (the
   (24576, 3072) gate weight pruned to 25 % in (8, 128) blocks, advised and
   stored as BSR) at decode batches 1, 8 and 64 through the BELL kernel,
   against dense ``x @ W.T``, every value dtype against the plain version,
   the decode (B = 1) and wide (B = 8, 64) paths counted apart, two calls
   bit-equal, with the dense cuBLAS and torch block-sparse yardsticks, and an
   unstructured 10 % SELL layer through kernel 5; (b) ``ops.grouped_gemm``
   at DeepSeek-V2-Lite expert width (64 experts, 2048 x 1408, a 2048-token
   batch routed top-6) through the grouped GEMM's SIMT kernel in f32 and its
   wgmma kernel in bf16 (per-path launch counters);
   (c) ``PlanConfig(format="bsr")`` and ``format="auto"`` on an 8192^2
   block-sparse matrix, every candidate timed (the fit of the ``h100`` bsr
   efficiency), and a matrix held out of that fit;
10. the corpus on the card: each of the twelve ``core.corpus`` specs in
   every format it lists, plus ``coo``, plus ``matrix_free`` through
   ``corpus.matrix_free_operator`` where the spec is flagged, compiled with
   ``PlanConfig(format=...)``; ``plan(x)`` and ``plan.spmm(X)`` (K = 4, f64
   and f32 x) against a host f64 product; kernels 1-6 each launched; the
   cold ``format="auto"`` pick of each spec; and on one plan the
   robustness checks: a ``plan.spmv`` fault poisons ``plan(x)``,
   ``check_finite_columns`` flags the poisoned column of a ``plan.spmm``
   fault, ``lanczos`` raises ``LanczosBreakdown``, and after
   ``faults.reset()`` the plan returns its earlier bits;
11. MatrixMarket at the paper's scale: ``write_mtx`` of the N = 1,201,200
   surrogate into ``build/corpus/``, ``load_matrix(..., validate="strict")``
   back (CSR arrays bitwise those in memory), a ``format="auto"`` plan and
   64 Lanczos steps whose E0 equals the in-memory plan's bit for bit, with
   the host seconds of the write, the read, the validation and the compile;
12. serving: (a) phase 8's surrogate SELL registered in a
   ``serve.BatchingSpMVServer`` priced on ``card_chip()``, width from
   ``select_batch_width``; 8 x width f64 requests and a padded partial
   batch through kernel 5 (one launch a flush, nothing else), every future
   against ``plan(x)`` (kernel 1), two servings bit-equal, the served SpMV/s
   over a window of ``SERVE_WINDOW_S`` seconds a side, in turns with the
   guardrails-off server (all the work over all the time, and the spread of
   the rounds), beside phase 8's kernel-only rate, and one flush's device
   steps each timed alone by CUDA events (operand, kernel 5, verdict) beside
   the flush's host and wall time; (b) a width-1 server (kernel 1, bitwise
   ``plan(x)``), and the exact L = 6 operator beside the surrogate in one
   server, both flushed by ``pump()`` past the deadline (kernel 4 once a
   real column: a column-by-column SpMM is not padded), and the exact
   operator's flush timed at full and at partial width; (c) on a small
   corpus spec: transient retry, poison isolation, a persistent ``cuda``
   failure ending in a ``KernelFault`` on each request (a card kernel has
   no plain rung to fall to) and clean bits after, queue-full shedding, a
   request timeout, and the bits back after ``faults.reset()``;
13. distributed SpMV on a mesh of 4 shards that all sit on cuda:0 (so
   nothing is communicated; the times are no scaling result): (a) the
   packings' host seconds at N = 1,201,200; the surrogate compiled under
   both partitioners (``nnz``, ``rows``), with ``slab_format="auto"`` and
   ``"ell"``, in each variant (``allgather``, ``ring``, ``overlap``);
   ``plan(x)`` in f64 and f32 and ``plan.spmm(X)`` at K = 16 against a host
   f64 product and the csr plan (kernel 3), two calls bitwise, kernel 1
   (kernel 5 for SpMM) launched once a non-empty slab and nothing else, ms
   per SpMV beside the local sell and csr plans, the modelled against the
   read matrix bytes, the modelled collective bytes beside the bytes
   moved, and each shard's slabs timed alone (the straggler of each cut
   beside the modelled imbalance); (b) 64 steps of ``lanczos(m, n,
   mesh=mesh4)`` against the csr plan's from the same v0 (alphas and betas
   within 1e-8, E0 within 1e-10) and its time a step beside phase 3's; (c)
   ``register_distributed`` on the mesh (one flush = one ``plan.spmm``,
   kernel 5 once a slab, futures against ``plan(x)``, the mesh stats) and,
   on a small corpus spec, a transient ``dist.spmm`` failure retried
   bitwise and a ``ShardDeath`` ending in a ``KernelFault`` on each request
   (no degrade), clean bits after ``faults.reset()``;
14. the LM serving path at Qwen3-0.6B's full width (28 layers, d 1024,
   16 / 8 heads, d_ff 3072, vocab 151,936; random weights from a seeded
   generator on the card): (a) the parameter count against
   ``Model.total_params()``; (b) at f32 compute, prefill's last logits and
   one decode step against ``lm_forward`` at positions S - 1 and S (B = 2,
   S = 16, within 1e-4 of max|logits|); (c) the same parameters through
   the port's CPU path on the same tokens (1e-4 relative); (d)
   ``launch.serve.main(["--arch", "qwen3-0.6b", "--requests", "4"])``
   (prompt 16, 24 new tokens, max_len 128, greedy, bf16 compute), the same
   ``Engine`` wave twice more with equal token lists and no counted kernel
   launched, with prefill and decode-step times (CUDA events), tokens/s,
   ``decode_bytes_per_token`` and the rate it implies, and a profiler
   split of one decode step (device time, casts); (e) layer 0's FFN gate
   weight (3072 x 1024) pruned to 25 % in (8, 128) blocks as a
   ``SparseLinear.from_dense(fmt="auto")`` on the card, as the reference's
   ``examples/serve_sparse.py`` does: at B = 4 its kernel (BELL, kernel 6;
   or SELL, kernel 5) once a call and nothing else, against dense
   ``x @ W.T`` and its plain version; (f) every other architecture's
   ``reduced`` config on the card: the prefill / decode consistency of (b),
   one bf16 ``Engine`` wave for each token-input arch, and ``dropped_frac``
   of the MoE archs' first MoE layer;
15. the training path (``TRAIN_ARCH`` = Qwen3-0.6B): (a) for every
   architecture's ``reduced`` config at f32 compute (TF32 off for this
   check and after), one ``make_train_step`` step on the card against the
   same step on the host from the same parameters and batch: loss and
   grad_norm within 1e-5 relative, every grad leaf within 1e-4 of its
   max|g| (one bf16 ulp, 2^-7, for jamba's bf16 leaves), the parameters
   after the step within 2 * lr; (b) ``launch.train.main`` at full width
   (remat "full", bf16 compute, f32 parameters and AdamW state; B = 8,
   S = 128, 20 steps, lr 1e-3, warmup 2, a checkpoint every 10 steps under
   ``build/train_ckpt``): every loss finite, the last below the first, no
   counted kernel launched, the peak memory; (c) step 10's checkpoint
   restored into a fresh module and opt state and saved again (the files
   equal byte for byte; restore and save seconds, bytes), then steps 11-20
   from it against the uninterrupted run's losses (1e-6 relative; whether
   bitwise is reported); the checkpoints are deleted after; (d) the wall
   ms a step, one profiled step's device ms and kernels, the optimizer
   alone, tokens/s and the model TFLOP/s at 6 N tokens, beside the card;
16. the dry-run and roofline tools: (a) ``launch.dryrun`` on the ``meta``
   device (no allocation, no card) at full width on the (16, 16) production
   mesh for every shape of ``DRY_ARCHS`` (Qwen3-0.6B and DeepSeek-V2-Lite,
   an MoE arch), run as child processes in three background lanes from the
   end of the build (``MetaSweep``): every cell ``ok`` or skipped for the
   reference's reason, no counted kernel, no collective or temp count
   reported as a number; each cell's host seconds and the roofline table
   (``launch.roofline.table_from_jsonl``) on the H100 data sheet; (b)
   ``launch.hillclimb --cell qwen3_train --iter dp_only`` (its record under
   ``chiprun_out/phase16/``; the depth fit equal to the full-depth count),
   then that per-device program on the card -- B = 1, S = 4096, remat full,
   bf16 compute, the f32 parameters and AdamW state whole -- counted under
   ``utils.op_flops.OpCounter``: its matmul FLOPs x 256 equal the meta
   record's exactly, no counted kernel launched, every loss finite; the
   step's device ms (CUDA events, median of ``DRY_STEPS``) and wall ms, one
   profiled step's kernels, device time and idle share, the
   peak memory beside the arguments the card holds, the roofline row
   (compute at 989 TFLOP/s, memory analytic and counted at 3.35 TB/s), the
   critical term's share of the step and the model FLOP/s as a share of
   989 TFLOP/s; (c) one ``decode_32k`` step at B = 1 against a 32,768-token
   cache: finite logits, its counted bytes beside params + cache and their
   time at 3.35 TB/s, and its device ms.
17. the examples at the paper's scale: each ``repro_torch.examples``
   module's ``main()`` in-process on the card, the launch counters read
   around it: (a) ``quickstart --n 1201200``: the advised plan through its
   CUDA kernels once an SpMV (y, then 48 Lanczos steps), ``plan(x)`` within
   ``TOL`` of a host f64 product, the alphas and betas within 1e-6 (of
   their max) of a ``torch``-entry run from the same v0; (b)
   ``eigensolver_holstein --n 1201200 --lanczos-steps 64``: the exact L = 3
   E0 against dense ``eigvalsh`` (1e-5), each of the five formats' plans
   against a host f64 product and its GFLOP/s, the kernels once a call, the
   winner's E0 against a ``torch``-entry run (1e-6 relative), the SpMV
   share of the Lanczos time, the distributed plan (one shard a card)
   within 1e-5 of the serial plan, kernel 1 once a slab; (c)
   ``matrix_free_laplacian --nx EX_NX`` (1,404,928 rows): ``materialize``
   bitwise, kernel 4 once an SpMV and kernel 3 once a call, the card's
   STREAM calibration (kernel 8) made anew, the measured against the
   modelled B/nnz, each plan within ``TOL`` of a host f64 product and the
   two within 1e-5 of each other; (d) ``distributed_spmv --n
   1201200``: every variant within 1e-5 of the CSR product, kernel 1 once a
   non-empty slab a call; (e) ``serve_sparse --full``: Qwen3-0.6B's layer-0
   gate (3072 x 1024) at 25 % in (8, 128) blocks through its kernel (6, or
   5) once and nothing else on the path, within 1e-5 of dense, the engine's
   wave twice with equal tokens; (f) ``serving_load --n 1201200``: kernel 5
   once a flush and nothing else, every future within ``TOL`` of
   ``plan(x)``, the reference's two assertions, each run's wall-clock
   req/s; (g) ``train_lm --steps EX_TRAIN_STEPS`` (the ~100M config, cut
   from 300; its checkpoints under ``build/`` deleted after): every logged
   loss finite, the last below the first, no counted kernel, wall ms a step
   and tokens/s.

Phase 7 ends with the measured warm path: every timed candidate of its
seven matrices recorded into a ``core.tunedb.TuneDB`` (keyed by signature,
``h100``, ``cuda``, value dtype), saved to
``chiprun_out/tunedb_h100.json`` and reloaded; each matrix rebuilt as a
new object must then compile, under ``PlanConfig(format="auto",
tuning=db)``, to the measured fastest format; ``fit_efficiency_from_db`` is
logged beside the committed ``h100`` table.

It prints a ``kernels`` JSON line (with each kernel's launches on the
serving, the distributed, the LM and the examples' paths; the training path
of phase 15 and the steps of phase 16 launch none of them) before the last
line and ends with
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero; without CUDA, or without the repository beside it, it
prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
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

#: budget of each narrow storage dtype against the f64 product of the same
#: weights, relative to its max magnitude: rounding of the stored values,
#: plus the per-group scale for int8 / fp8 (the reference's VALUE_DTYPE_TOL)
VALUE_DTYPE_TOL = {"f32": 1e-5, "bf16": 3e-2, "f16": 1e-2, "fp8_e4m3": 2e-1,
                   "int8": 5e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: seconds of serving a side behind phase 12's served rates: long enough
#: for a stall or a slow flush to show in the rate
SERVE_WINDOW_S = 1.0


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


def kernel_launches(counts: dict) -> int:
    """Launches of every kernel in ``cuda_build.launch_counts()``'s copy,
    each once: a launch that also counts its path (``PATH_COUNTERS``) adds
    one."""
    from repro_torch.kernels import cuda_build as CB
    return sum(v for k, v in counts.items() if k not in CB.PATH_COUNTERS)


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


def ptxas_entries(build_log: str) -> list[dict]:
    """Per kernel entry of an ``nvcc -Xptxas=-v`` log: the (mangled) name,
    registers, static shared memory and spill bytes."""
    ents, cur = [], None
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"entry": m.group(1), "registers": None, "smem": 0,
                   "spill_stores": 0, "spill_loads": 0}
            ents.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return ents


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def device_split(torch, fn, what: str) -> tuple[dict, int]:
    """({kernel name: device us}, kernels) of one call of ``fn`` traced by
    torch.profiler; fails when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us, n_ev = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[ev.name] = dev_us.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            n_ev += 1
    check(n_ev > 0, f"torch.profiler traced no device time in {what}")
    return dev_us, n_ev



#: the architecture phase 14 serves at full width
LM_ARCH = "qwen3-0.6b"


#: the paper's HMeP as the Holstein-Hubbard model: 6 periodic sites, 3 up +
#: 3 down electrons, at most 8 phonons in total (400 x 3003 = 1,201,200 rows)
HMEP_EXACT = {"L": 6, "n_up": 3, "n_dn": 3, "max_phonon": 8, "max_total_phonon": 8}


def mf_product_phase(torch, dev, args, record, compare, ex6, xe6) -> dict:
    """Phase 4d, kernel ``mf_product`` (the module docstring lists its
    checks): the exact HMeP at ``HMEP_EXACT`` with ``args.hmep_cap`` phonons
    at most, then 4c's exact L = 6 operator ``ex6`` (kernel 4's, no total
    cap) at ``xe6`` through both kernels.  ``record`` and ``compare`` are
    main's: a kernel row's fields, and a check against a reference
    product."""
    from repro_torch.core import matrices as M
    from repro_torch.core.eigensolver import lanczos
    from repro_torch.core.plan import SpMVPlan
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.kernels import cuda_build as CB
    from repro_torch.kernels import mf_product as MP
    from repro_torch.utils.hw import H100

    def solve_ms(plan, n, v0, reps=5):
        """Wall ms of one 96-step plain Lanczos solve through ``plan``."""
        for _ in range(2):
            lanczos(plan, n, m=96, v0=v0, reorthogonalize=False)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            lanczos(plan, n, m=96, v0=v0, reorthogonalize=False)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    t4d = time.perf_counter()
    cap = args.hmep_cap
    p = M.HolsteinHubbardParams(**{**HMEP_EXACT, "max_phonon": cap, "max_total_phonon": cap})
    op = M.holstein_hubbard_operator(p)
    build_s = time.perf_counter() - t4d
    csr = M.holstein_hubbard_exact(p)
    n = op.shape[0]
    check(csr.shape == op.shape and csr.nnz == op.nnz,
          f"mf_product: the operator has shape {op.shape} and {op.nnz} nnz, the CSR "
          f"{csr.shape} and {csr.nnz}")
    what = f"HMeP {n:,} rows f64"
    launch = MP.product_launch(op)
    tables = {k: v.to(dev) for k, v in launch.tables.items()}
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(n)).to(dev)
    k = lambda: MP.mf_product_arrays(launch, x)  # noqa: E731
    plain = lambda: MP.mf_product_plain(tables, x)  # noqa: E731
    got = k()
    err = compare("mf_product", what, got, plain())
    check(torch.equal(got, plain()), f"mf_product {what}: not bit for bit its composite "
                                     "version (the same sums in the same order)")
    check(torch.equal(got, k()), f"mf_product {what}: two calls differ")
    lib = torch.sparse_csr_tensor(csr.row_ptr.long(), csr.col_idx.long(), csr.val,
                                  size=csr.shape).to(dev)
    compare("mf_product", f"{what} vs cuSPARSE", got, lib @ x)
    plan_c = SpMVPlan.compile(csr, PlanConfig(format="csr"))
    check(plan_c.report.kernel == "cuda", f"HMeP csr plan runs {plan_c.report.kernel}")
    # x read and y written once: the tables (287 KB) stay in the caches
    bnd, by = bound_ms(H100, 2 * 8 * n, 2 * op.nnz, "float64")
    row = {"rows": n, "nnz": op.nnz, "build_s": build_s, "max_abs_err": err,
           "ms": time_ms(torch, k), "plain_ms": time_ms(torch, plain),
           "library_ms": time_ms(torch, lambda: lib @ x),
           "csr_plan_ms": time_ms(torch, lambda: plan_c(x)), "bound_ms": bnd, "bound_by": by}
    del lib

    plan = SpMVPlan.compile(op, PlanConfig(format="mf_product"))
    check(plan.report.kernel == "cuda", f"mf_product plan runs {plan.report.kernel}")
    check(torch.equal(plan(x), got), "mf_product: the plan call is not the kernel's output")
    v0 = np.random.default_rng(22).standard_normal(n)
    CB.reset_launch_counts()
    res = lanczos(plan, n, m=args.lanczos_steps, v0=v0, reorthogonalize=False)
    counts = CB.launch_counts()
    check(counts.get("mf_product", 0) == res.n_spmv and kernel_launches(counts) == res.n_spmv,
          f"HMeP path: {counts} launches for {res.n_spmv} SpMVs (only mf_product, once each)")
    res_c = lanczos(plan_c, n, m=args.lanczos_steps, v0=v0, reorthogonalize=False)
    e0, e0c = float(res.eigenvalues[0]), float(res_c.eigenvalues[0])
    de0 = abs(e0 - e0c) / max(1e-300, abs(e0c))
    check(de0 <= 1e-8, f"HMeP path: E0 {e0!r} vs the csr plan's {e0c!r}")
    v0t = torch.from_numpy(v0).to(dev)
    row.update(launches=counts["mf_product"], steps=res.n_spmv, E0=e0, E0_csr_plan=e0c,
               E0_rel_diff_vs_csr=de0, solve_ms=solve_ms(plan, n, v0t),
               csr_solve_ms=solve_ms(plan_c, n, v0t))
    record("mf_product", route="cuda", source="src/repro_torch/csrc/mf_product.cu",
           replaces="none: the port's own (the exact HMeP's total phonon cap)",
           max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=bnd,
           bound_by=by, library_ms=row["library_ms"], launches=counts["mf_product"],
           launches_per_lanczos_step=counts["mf_product"] / res.n_spmv,
           shape=f"{what}, {op.nnz:,} nnz (bound: x read, y written)")
    log(f"[mf_product] {what} ({op.nnz:,} nnz, tables built in {build_s:.3f} s): kernel "
        f"{row['ms']:.4f} ms, composite {row['plain_ms']:.4f}, cuSPARSE f64 "
        f"{row['library_ms']:.4f}, stored csr plan {row['csr_plan_ms']:.4f}; bound "
        f"{bnd:.4f} ms by {by}; {res.n_spmv} Lanczos steps, {counts['mf_product']} launches, "
        f"E0 {e0:.12f} (csr plan {e0c:.12f}, rel diff {de0:.1e}); a 96-step solve "
        f"{row['solve_ms']:.3f} ms (csr plan {row['csr_solve_ms']:.3f})")
    del plan, plan_c, res_c, tables

    # the exact L = 6 operator of phase 4c: no total cap, so kernel 4 takes it too
    p6 = M.HolsteinHubbardParams(L=args.exact_L, max_phonon=args.exact_phonon)
    op6 = M.holstein_hubbard_operator(p6)
    check(op6.shape == ex6.shape and op6.nnz == ex6.nnz,
          f"mf_product: L = {args.exact_L} operator {op6.shape}, {op6.nnz} nnz; kernel 4's "
          f"{ex6.shape}, {ex6.nnz}")
    plan_6 = SpMVPlan.compile(op6, PlanConfig(format="mf_product"))
    plan_4 = SpMVPlan.compile(ex6, PlanConfig())
    check(plan_6.report.kernel == plan_4.report.kernel == "cuda",
          f"L = {args.exact_L}: plans run {plan_6.report.kernel}, {plan_4.report.kernel}")
    compare("mf_product", f"exact L={args.exact_L} vs kernel 4", plan_6(xe6), plan_4(xe6))
    v06 = torch.from_numpy(np.random.default_rng(23).standard_normal(op6.shape[0])).to(dev)
    row["exact_l6"] = {
        "rows": op6.shape[0], "nnz": op6.nnz,
        "mf_product_ms": time_ms(torch, lambda: plan_6(xe6)),
        "kernel4_ms": time_ms(torch, lambda: plan_4(xe6)),
        "mf_product_solve_ms": solve_ms(plan_6, op6.shape[0], v06),
        "kernel4_solve_ms": solve_ms(plan_4, op6.shape[0], v06)}
    r6 = row["exact_l6"]
    log(f"[mf_product] exact L={args.exact_L} max_phonon={args.exact_phonon} "
        f"({op6.shape[0]:,} rows): mf_product {r6['mf_product_ms']:.4f} ms, kernel 4 "
        f"{r6['kernel4_ms']:.4f} ms a plan call; a 96-step solve {r6['mf_product_solve_ms']:.3f} "
        f"against {r6['kernel4_solve_ms']:.3f} ms")
    row["host_s"] = time.perf_counter() - t4d
    return row


def lm_phase(torch, dev, smi: str, record, compare) -> dict:
    """Phase 14, the LM serving path at ``LM_ARCH``'s full width (the module
    docstring lists its checks).  The reference's LM path reaches no
    ``pallas_call`` (attention in plain jnp, expert GEMMs as einsums), so the
    model runs on torch ops; the kernel on this path is the pruned FFN
    weight's (14e), as ``examples/serve_sparse.py`` drives it.  ``record``
    and ``compare`` are main's: a kernel row's fields, and a check of a
    kernel against its plain version."""
    from repro_torch.configs import reduced as lm_reduced
    from repro_torch.kernels import cuda_build as CB
    from repro_torch.launch import serve as LAUNCH
    from repro_torch.models import moe as LM_MOE
    from repro_torch.models import transformer as LMT
    from repro_torch.models import whisper as LMW
    from repro_torch.models.layers import apply_embed, apply_rmsnorm
    from repro_torch.models.registry import Model as LMModel
    from repro_torch.models.registry import get_config as lm_config
    from repro_torch.models.sparse import SparseLinear, advise_weight_format, magnitude_prune
    from repro_torch.serve.engine import Engine, GenerationConfig
    from repro_torch.utils.hw import H100
    from repro_torch.utils.tree import param_bytes, param_count

    t14 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = torch.float32
    lm = {}


    def wall_ms(fn, reps: int = 10) -> float:
        """Median of CUDA-event times around ``reps`` calls, each waited for:
        what a caller that needs the result waits, host work included."""
        fn()
        ts = []
        for _ in range(reps):
            s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_.record()
            fn()
            e_.record()
            e_.synchronize()
            ts.append(s_.elapsed_time(e_))
        return float(np.median(ts))

    def consistency(model_, mod_, B=2, S=16, seed=14):
        """(prefill, decode) rel errors against lm_forward at S - 1 and S."""
        cfg_ = model_.cfg
        rng_ = np.random.default_rng(seed)
        toks = torch.from_numpy(rng_.integers(0, cfg_.vocab, (B, S + 1))).to(dev)
        emb = torch.from_numpy(rng_.standard_normal((B, S + 1, cfg_.d_model),
                                                    dtype=np.float32)).to(dev)
        cache_ = model_.init_cache(B, S + 4, device=dev)
        with torch.no_grad():
            if cfg_.family == "encdec":
                full_ = LMW.decode(mod_, cfg_, toks, LMW.encode(mod_, cfg_, emb))[0]
                pre_, cache_ = model_.prefill(mod_, {"enc_embeds": emb, "tokens": toks[:, :S]},
                                              cache_)
                nxt = toks[:, S]
            elif cfg_.input_mode == "embeds":
                full_ = LMT.lm_forward(mod_, cfg_, emb)[0]
                pre_, cache_ = model_.prefill(mod_, {"embeds": emb[:, :S]}, cache_)
                nxt = emb[:, S]
            else:
                full_ = LMT.lm_forward(mod_, cfg_, toks)[0]
                pre_, cache_ = model_.prefill(mod_, {"tokens": toks[:, :S]}, cache_)
                nxt = toks[:, S]
            dec_, _ = model_.decode_step(mod_, cache_, nxt, S)
        scale = float(full_.abs().max())
        return (float((pre_ - full_[:, S - 1]).abs().max()) / scale,
                float((dec_ - full_[:, S]).abs().max()) / scale, full_, toks)

    # 14a. the parameters, initialized on the card from a seeded generator
    arch = LM_ARCH
    qcfg = lm_config(arch)
    qmodel = LMModel(qcfg)
    qmod = qmodel.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    n_par = param_count(qmod)
    check(n_par == qmodel.total_params(), f"{arch}: {n_par} parameters, "
          f"total_params() {qmodel.total_params()}")
    lm["arch"], lm["params"], lm["param_bytes"] = arch, n_par, param_bytes(qmod)
    lm["card_mem_in_use_bytes"] = torch.cuda.memory_allocated()
    log(f"[lm] {arch}: {qcfg.n_layers} layers, d {qcfg.d_model}, heads "
        f"{qcfg.n_heads} / {qcfg.n_kv_heads} x {qcfg.head_dim}, d_ff {qcfg.d_ff}, vocab "
        f"{qcfg.vocab}: {n_par:,} parameters (= total_params()), "
        f"{lm['param_bytes'] / 1e9:.3f} GB f32; card memory in use "
        f"{lm['card_mem_in_use_bytes'] / 1e9:.3f} GB")

    # 14b. prefill / decode consistency at f32 compute
    q32 = LMModel(dataclasses.replace(qcfg, compute_dtype=f32, cache_dtype=f32))
    e_pre, e_dec, full32, toks32 = consistency(q32, qmod)
    check(e_pre < 1e-4 and e_dec < 1e-4, f"{arch}: prefill {e_pre:.2e} / decode "
          f"{e_dec:.2e} from lm_forward (bound 1e-4 of max|logits|)")

    # 14c. the same parameters on the host, through the port's CPU path
    t0 = time.perf_counter()
    host_mod = q32.build("cpu")
    host_mod.load_state_dict(qmod.state_dict())
    with torch.no_grad():
        host = LMT.lm_forward(host_mod, q32.cfg, toks32.cpu())[0]
    _, e_host = rel_err(torch, full32.cpu(), host)
    check(e_host <= 1e-4, f"{arch}: card logits {e_host:.2e} from the host's "
                          "(bound 1e-4 relative, f32 compute)")
    lm.update(prefill_rel_err=e_pre, decode_rel_err=e_dec, card_vs_host_rel_err=e_host,
              host_s=time.perf_counter() - t0)
    log(f"[lm] f32 compute, B=2 S=16: prefill {e_pre:.2e}, decode {e_dec:.2e} of "
        f"max|logits| from lm_forward; card vs host {e_host:.2e} relative "
        f"({lm['host_s']:.1f} s of host forward)")
    # layer 0's FFN gate (d_ff, d_model), for 14e: the parameters 14d serves
    w_gate = qmod.units[0].mlp.wi_gate.detach().T.contiguous().cpu().numpy()
    del host_mod, host, full32, qmod
    torch.cuda.empty_cache()

    # 14d. serving through the entry point a user calls
    CB.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = LAUNCH.main(["--arch", arch, "--requests", "4"])
    check(torch.equal(
        served["engine"].params.units[0].mlp.wi_gate.detach().T.cpu(),
        torch.from_numpy(w_gate)), "launch.serve drew other parameters than 14a")
    lm["serve_main_s"] = time.perf_counter() - t0
    eng, prompts, gcfg = served["engine"], served["prompts"], served["gen_cfg"]
    waves, wave_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        waves.append(eng.generate(prompts, gcfg))
        wave_s.append(time.perf_counter() - t0)
    check(waves[0] == waves[1] == served["outs"], f"{arch}: the same Engine wave "
          "gave other tokens")
    check(all(len(o) == gcfg.max_new_tokens for o in waves[0]), "a request stopped early")
    check(sum(CB.launch_counts().values()) == 0, f"the dense LM path launched counted "
          f"kernels: {CB.launch_counts()}")
    ptoks = torch.as_tensor(prompts, device=dev)
    plen = ptoks.shape[1]

    def prefill_call():
        return eng.model.prefill(eng.params, {"tokens": ptoks}, eng.cache)

    lg0, _ = prefill_call()
    tok0 = lg0.argmax(-1)

    def decode_call():
        return eng.model.decode_step(eng.params, eng.cache, tok0, plen)

    pre_ms, dec_ms = wall_ms(prefill_call), wall_ms(decode_call, reps=20)
    n_tok = sum(len(o) for o in waves[0])
    bpt = eng.decode_bytes_per_token()
    # one decode step's device time by kernel: the casts beside the rest
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tr:
        for _ in range(5):
            decode_call()
        torch.cuda.synchronize()
    dev_us, n_ev = {}, 0
    for ev in tr.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[ev.name] = dev_us.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 5
            n_ev += 1
    check(n_ev > 0, "torch.profiler traced no device time in the decode step")
    cast_us = sum(t for k, t in dev_us.items() if "copy" in k.lower())
    prof = {"device_ms": sum(dev_us.values()) / 1e3, "cast_copy_ms": cast_us / 1e3,
            "kernels_per_step": n_ev / 5,
            "top": sorted(((round(t / 1e3, 4), k[:80]) for k, t in dev_us.items()),
                          reverse=True)[:6]}
    lm.update(tokens=waves[0], prefill_ms=pre_ms, decode_step_ms=dec_ms,
              wave_s=wave_s, tok_s=[n_tok / t for t in wave_s],
              decode_bytes_per_token=bpt, implied_gb_s=bpt / (dec_ms * 1e-3) / 1e9,
              decode_profile=prof)
    log(f"[lm] launch.serve {arch} --requests 4 (prompt {plen}, "
        f"{gcfg.max_new_tokens} new, max_len {eng.max_len}, greedy, bf16): {n_tok} tokens, "
        f"two more waves equal; prefill {pre_ms:.3f} ms, decode step {dec_ms:.3f} ms (CUDA "
        f"events, median), waves {', '.join(f'{n_tok / t:.1f}' for t in wave_s)} tok/s; "
        f"decode_bytes_per_token {bpt / 1e9:.4f} GB -> {lm['implied_gb_s']:.1f} GB/s at the "
        f"decode step's time ({100 * lm['implied_gb_s'] / 3350:.1f} % of 3.35 TB/s); "
        f"profiled step: {prof['device_ms']:.3f} ms of device time in "
        f"{prof['kernels_per_step']:.0f} kernels, casts / copies "
        f"{prof['cast_copy_ms']:.3f} ms; card: {smi}")
    for t_ms, name in prof["top"]:
        log(f"[lm]   {t_ms:.4f} ms  {name}")

    # 14e. the pruned FFN gate weight of layer 0 as a SparseLinear
    w_sp = magnitude_prune(w_gate, 0.25, structured=(8, 128))
    advised_lm = advise_weight_format(w_sp, (8, 128))
    lin_lm = SparseLinear.from_dense(w_sp, fmt="auto", device=dev)
    kname = "bell_spmm" if lin_lm.fmt == "bsr" else "sell_spmm"
    x_lm = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (4, w_sp.shape[1]), dtype=np.float32)).to(dev)
    W_lm = torch.from_numpy(w_sp).to(dev)
    CB.reset_launch_counts()
    ys_lm = [lin_lm(x_lm) for _ in range(3)]
    torch.cuda.synchronize()
    counts_lm = CB.launch_counts()
    others = {k: v for k, v in counts_lm.items()
              if v and k != kname and not k.startswith(kname + "_")}
    check(counts_lm[kname] == 3 and not others, f"SparseLinear on the LM weight: {kname} "
          f"launched {counts_lm[kname]} times for 3 calls; others {others}")
    record(kname, launches_lm=counts_lm[kname])
    plain_lm = SparseLinear.from_dense(w_sp, fmt=lin_lm.fmt, backend="torch", device=dev)
    err_lm = compare(kname, f"LM FFN gate {tuple(w_sp.shape)} B=4 vs plain", ys_lm[0],
                     plain_lm(x_lm))
    compare(kname, f"LM FFN gate {tuple(w_sp.shape)} B=4 vs dense", ys_lm[0], x_lm @ W_lm.T)
    check(all(torch.equal(ys_lm[0], y) for y in ys_lm[1:]), "SparseLinear: calls differ")
    sb = lin_lm.streamed_bytes()
    lm["sparse_ffn"] = {
        "shape": list(w_sp.shape), "advised": advised_lm, "fmt": lin_lm.fmt, "kernel": kname,
        "launches": counts_lm[kname], "calls": 3, "max_abs_err_vs_plain": err_lm,
        "layer_ms": time_ms(torch, lambda: lin_lm(x_lm)),
        "plain_ms": time_ms(torch, lambda: plain_lm(x_lm), reps=5),
        "dense_ms": time_ms(torch, lambda: x_lm @ W_lm.T), "streamed_bytes": sb,
        "bound_ms": sb / H100.hbm_bytes_per_s * 1e3}
    sf = lm["sparse_ffn"]
    log(f"[lm] sparse FFN gate {tuple(w_sp.shape)} at 25 % in (8, 128) blocks: advised "
        f"{advised_lm}, stored {lin_lm.fmt}; {kname} once a call (3 of 3, nothing else); "
        f"B=4: layer {sf['layer_ms']:.4f} ms, plain {sf['plain_ms']:.4f}, dense x @ W.T "
        f"{sf['dense_ms']:.4f}; streamed_bytes {sb / 1e6:.3f} MB (bound "
        f"{sf['bound_ms']:.4f} ms at 3.35 TB/s)")
    del eng, served, lin_lm, plain_lm, W_lm
    torch.cuda.empty_cache()

    # 14f. every other architecture's reduced config on the card
    lm["archs"] = {}
    for name in ("gemma-7b", "minicpm-2b", "glm4-9b", "pixtral-12b", "moonshot-v1-16b-a3b",
                 "deepseek-v2-lite-16b", "mamba2-2.7b", "whisper-tiny",
                 "jamba-1.5-large-398b"):
        rcfg_b = lm_reduced(lm_config(name))
        rm32 = LMModel(dataclasses.replace(rcfg_b, compute_dtype=f32, cache_dtype=f32))
        rmod = rm32.init(torch.Generator(device=dev).manual_seed(1), device=dev)
        a_pre, a_dec, _, atoks = consistency(rm32, rmod)
        check(a_pre < 1e-4 and a_dec < 1e-4, f"{name} (reduced): prefill {a_pre:.2e} / "
              f"decode {a_dec:.2e} from the forward (bound 1e-4)")
        row = {"prefill_rel_err": a_pre, "decode_rel_err": a_dec}
        if rcfg_b.family != "encdec" and rcfg_b.input_mode == "tokens":
            eng_b = Engine(LMModel(rcfg_b), rmod, batch_size=2, max_len=48, device=dev)
            outs_b = eng_b.generate(np.random.default_rng(16).integers(
                0, rcfg_b.vocab, (2, 8)), GenerationConfig(max_new_tokens=6))
            check(all(len(o) == 6 and all(0 <= t < rcfg_b.vocab for t in o) for o in outs_b),
                  f"{name}: bf16 Engine wave gave {outs_b}")
            row["bf16_tokens"] = outs_b
        if rcfg_b.moe is not None:
            unit = rmod.units[0].l1 if rcfg_b.family == "hybrid" else rmod.units[0]
            with torch.no_grad():
                xm = apply_embed(rmod.embed, atoks, f32)
                _, aux_m = LM_MOE.moe_apply(unit.moe, apply_rmsnorm(unit.ln_ffn, xm),
                                            rcfg_b.moe, compute_dtype=f32)
            row["dropped_frac"] = float(aux_m["dropped_frac"])
        lm["archs"][name] = row
        log(f"[lm] {name} (reduced, {rcfg_b.family}): prefill {a_pre:.2e}, decode "
            f"{a_dec:.2e}" + (f"; bf16 wave {row['bf16_tokens']}" if "bf16_tokens" in row
                              else "") + (f"; dropped_frac {row['dropped_frac']:.4f}"
                                          if "dropped_frac" in row else ""))
        del rmod
    lm["phase_s"] = time.perf_counter() - t14
    log(f"[lm] phase 14 took {lm['phase_s']:.1f} s")
    return lm


#: the architecture phase 15 trains at full width
TRAIN_ARCH = "qwen3-0.6b"
#: phase 15b's run: batch, sequence, steps, peak learning rate (warmup 2)
TRAIN_RUN = {"batch": 8, "seq": 128, "steps": 20, "lr": 1e-3}


def _leaf_err(a, b) -> float:
    """max|a - b| / max|b| of one leaf in f64 (the raw difference for an
    all-zero leaf)."""
    a, b = a.double().cpu(), b.double().cpu()
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return err / scale if scale else err


def train_phase(torch, dev, smi: str) -> dict:
    """Phase 15, the training path: (a) one train step of every reduced
    architecture on the card against the same step on the host; (b)
    ``launch.train`` at ``TRAIN_ARCH``'s full width; (c) a checkpoint round
    trip at full width; (d) the step's numbers (the module docstring lists
    the checks).  The reference's training path reaches no ``pallas_call``
    (plain-jnp layers, einsum experts, no custom gradients), so none of the
    nine kernels runs here: the phase checks that none is launched."""
    import filecmp
    import math
    import shutil

    from repro_torch.configs import reduced as lm_reduced
    from repro_torch.configs import smoke_batch
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.kernels import cuda_build as CB
    from repro_torch.launch import train as LAUNCH_TRAIN
    from repro_torch.models.registry import Model as LMModel
    from repro_torch.models.registry import get_config as lm_config
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import trainer as TR
    from repro_torch.utils.tree import param_count

    t15 = time.perf_counter()
    tr = {}
    # f32 products in f32 on both sides of (a): no TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 15a. one step of every reduced architecture, card against host
    lr_a = 1e-2
    ocfg_a = OPT.OptimizerConfig(lr=lr_a, warmup_steps=1, schedule="const")
    tr["archs"] = {}
    for name in ("gemma-7b", "qwen3-0.6b", "minicpm-2b", "glm4-9b", "pixtral-12b",
                 "moonshot-v1-16b-a3b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                 "whisper-tiny", "jamba-1.5-large-398b"):
        cfg = lm_reduced(lm_config(name), compute_dtype=torch.float32)
        model = LMModel(cfg)
        host = model.init(torch.Generator().manual_seed(2), device="cpu")
        card = model.build(dev)
        card.load_state_dict(host.state_dict())
        hb = smoke_batch(cfg, torch.Generator().manual_seed(3))
        cb = {k: v.to(dev) for k, v in hb.items()}
        loss_h, _, g_h = TR.loss_and_grads(model, host, hb)
        loss_c, _, g_c = TR.loss_and_grads(model, card, cb)
        # bf16 leaves (jamba's parameters) round their grads to bf16: one ulp
        g_err = max(_leaf_err(g_c[k], g_h[k]) / (2.0 ** -7 if g_h[k].dtype == torch.bfloat16
                                                  else 1e-4) for k in g_h)
        step = TR.make_train_step(model, ocfg_a)
        _, _, m_h = step(host, OPT.init_opt_state(host), hb)
        _, _, m_c = step(card, OPT.init_opt_state(card), cb)
        e_loss = abs(float(m_c["loss"]) - float(m_h["loss"])) / abs(float(m_h["loss"]))
        e_gn = abs(float(m_c["grad_norm"]) - float(m_h["grad_norm"])) / float(m_h["grad_norm"])
        hp = dict(host.named_parameters())
        p_err = max(float((p.detach().double().cpu() - hp[k].detach().double()).abs().max())
                    for k, p in card.named_parameters())
        check(e_loss <= 1e-5 and e_gn <= 1e-5 and g_err <= 1 and p_err <= 2 * lr_a,
              f"{name} (reduced): card train step against the host's: loss {e_loss:.2e}, "
              f"grad_norm {e_gn:.2e} (bounds 1e-5 relative), grads {g_err:.2e} of their "
              f"bound, parameters {p_err:.2e} (bound 2 * lr = {2 * lr_a})")
        tr["archs"][name] = {"loss_rel_err": e_loss, "grad_norm_rel_err": e_gn,
                             "grad_err_of_bound": g_err, "param_abs_err": p_err,
                             "loss": float(m_c["loss"])}
        log(f"[train] {name} (reduced, f32, TF32 off): card step vs host: loss {e_loss:.2e}, "
            f"grad_norm {e_gn:.2e}, grads {g_err:.2e} of 1e-4 of max|g|, parameters "
            f"{p_err:.2e} (bound {2 * lr_a})")
        del host, card

    # 15b. launch.train at full width: remat "full", bf16 compute
    arch = TRAIN_ARCH
    qcfg = lm_config(arch)
    check(qcfg.remat == "full" and qcfg.compute_dtype == torch.bfloat16,
          f"{arch}: remat {qcfg.remat}, compute {qcfg.compute_dtype}")
    ckdir = REPO / "build" / "train_ckpt"
    ckdir2 = REPO / "build" / "train_ckpt_resave"
    for d in (ckdir, ckdir2):
        shutil.rmtree(d, ignore_errors=True)
    ckdir.parent.mkdir(parents=True, exist_ok=True)
    tr["disk_free_bytes"] = shutil.disk_usage(ckdir.parent).free
    check(tr["disk_free_bytes"] > 16e9, f"{tr['disk_free_bytes'] / 1e9:.1f} GB free beside "
          "the checkpoints; phase 15 holds two full-width checkpoints (~14.3 GB)")
    B, S, n_steps = TRAIN_RUN["batch"], TRAIN_RUN["seq"], TRAIN_RUN["steps"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold is not the training's: the peak is
    # reported above it
    tr["mem_before_bytes"] = torch.cuda.memory_allocated()
    CB.reset_launch_counts()
    t0 = time.perf_counter()
    run = LAUNCH_TRAIN.main(["--arch", arch, "--steps", str(n_steps), "--batch", str(B),
                             "--seq", str(S), "--lr", str(TRAIN_RUN["lr"]), "--log-every", "1",
                             "--ckpt-every", "10", "--ckpt-dir", str(ckdir), "--no-resume"])
    torch.cuda.synchronize()
    tr["main_s"] = time.perf_counter() - t0
    tr["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - tr["mem_before_bytes"]
    check(sum(CB.launch_counts().values()) == 0, f"the training path launched counted "
          f"kernels: {CB.launch_counts()}")
    loop, model = run["loop"], run["model"]
    ocfg = loop.opt_cfg
    check(ocfg.warmup_steps == 2, f"warmup {ocfg.warmup_steps}")
    hist = loop.history
    losses = [h[1] for h in hist]
    n_par = param_count(run["params"])
    check([h[0] for h in hist] == list(range(1, n_steps + 1)), f"history steps {hist}")
    check(all(math.isfinite(x) for x in losses), f"{arch}: a non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f}: "
          "the last step's loss is not below the first's")
    check(int(run["opt_state"]["step"]) == n_steps, "opt state step")
    step_s = [h[2] for h in hist]
    tr.update(arch=arch, params=n_par, batch=B, seq=S, losses=losses, step_s=step_s,
              ln_vocab=math.log(qcfg.vocab))
    log(f"[train] launch.train {arch} (full width, {n_par:,} parameters, remat full, bf16 "
        f"compute, f32 parameters and AdamW state) B={B} S={S}, {n_steps} steps, lr "
        f"{ocfg.lr:g}, warmup {ocfg.warmup_steps}, {ocfg.schedule}: loss {losses[0]:.4f} "
        f"(ln {qcfg.vocab} = {math.log(qcfg.vocab):.4f}) -> {losses[-1]:.4f}; every loss "
        f"finite; no counted kernel launched; peak memory {tr['peak_mem_bytes'] / 1e9:.3f} GB "
        f"above the {tr['mem_before_bytes'] / 1e9:.3f} GB held before; main() "
        f"{tr['main_s']:.1f} s")
    log("[train] losses " + " ".join(f"{x:.4f}" for x in losses))
    params_b, opt_b = run["params"], run["opt_state"]
    del run, params_b, opt_b
    torch.cuda.empty_cache()

    # 15c. the checkpoint of step 10 into a fresh module and opt state, then
    # steps 11-20 against the uninterrupted run
    shutil.rmtree(ckdir / f"step_{n_steps:08d}")
    check(CK.available_steps(str(ckdir)) == [10], f"checkpoints {CK.available_steps(str(ckdir))}")
    step_dir = ckdir / "step_00000010"
    tr["ckpt_bytes"] = sum(f.stat().st_size for f in step_dir.iterdir())
    fresh = model.build(dev)
    fresh_opt = OPT.init_opt_state(fresh)
    t0 = time.perf_counter()
    restored = CK.restore(str(ckdir), 10, like={"params": fresh, "opt_state": fresh_opt})
    torch.cuda.synchronize()
    tr["restore_s"] = time.perf_counter() - t0
    check(restored["step"] == 10 and int(fresh_opt["step"]) == 10, "restored step")
    t0 = time.perf_counter()
    CK.save(str(ckdir2), 10, params=fresh, opt_state=fresh_opt, keep=1)
    tr["save_s"] = time.perf_counter() - t0
    names = sorted(f.name for f in step_dir.iterdir())
    same = filecmp.cmpfiles(step_dir, ckdir2 / "step_00000010", names, shallow=False)
    check(not same[1] and not same[2], f"the re-saved checkpoint differs from step 10's: "
          f"{same[1][:4]} {same[2][:4]}")
    shutil.rmtree(ckdir2)
    pipe = pipeline_for(model.cfg, shape_batch=B, seq_len=S, seed=0, device=dev)
    pipe.skip_to(10)
    step_fn = TR.make_train_step(model, ocfg)
    resumed = []
    for _ in range(n_steps - 10):
        _, _, met = step_fn(fresh, fresh_opt, pipe.next_batch())
        resumed.append(float(met["loss"]))
    r_err = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[10:]))
    check(r_err <= 1e-6, f"steps 11-{n_steps} from the checkpoint: losses {r_err:.2e} from "
          "the uninterrupted run's (bound 1e-6 relative)")
    tr.update(resumed_losses=resumed, resume_rel_err=r_err,
              resume_bitwise=resumed == losses[10:])
    log(f"[train] checkpoint of step 10: {len(names) - 1} leaves, {tr['ckpt_bytes'] / 1e9:.3f} "
        f"GB; restore into a fresh module {tr['restore_s']:.2f} s, save {tr['save_s']:.2f} s "
        f"(its files equal step 10's byte for byte); steps 11-{n_steps} from it: losses "
        f"{r_err:.2e} from the uninterrupted run's (bitwise: {tr['resume_bitwise']}); "
        f"{tr['disk_free_bytes'] / 1e9:.0f} GB were free")
    shutil.rmtree(ckdir)

    # 15d. the step's numbers: wall (host clock to synchronize, the loop's
    # heartbeat), device time and kernels of one step (torch.profiler), the
    # optimizer apart (CUDA events)
    tokens = B * S
    wall_ms = float(np.median(step_s[1:])) * 1e3
    batch = pipe.next_batch()
    step_fn(fresh, fresh_opt, batch)
    torch.cuda.synchronize()
    dev_us, n_ev = device_split(torch, lambda: step_fn(fresh, fresh_opt, batch),
                                "the train step")
    _, _, grads = TR.loss_and_grads(model, fresh, batch)
    opt_ms = time_ms(torch, lambda: OPT.adamw_update(ocfg, grads, fresh_opt, fresh), reps=10)
    opt_wall = []
    for _ in range(5):
        t0 = time.perf_counter()
        OPT.adamw_update(ocfg, grads, fresh_opt, fresh)
        torch.cuda.synchronize()
        opt_wall.append(time.perf_counter() - t0)
    device_ms = sum(dev_us.values()) / 1e3
    flops = 6 * n_par * tokens
    tr.update(wall_ms_per_step=wall_ms, device_ms_per_step=device_ms, kernels_per_step=n_ev,
              optimizer_ms=opt_ms, optimizer_wall_ms=float(np.median(opt_wall)) * 1e3,
              tokens_per_s=tokens / (wall_ms * 1e-3),
              model_tflops=flops / (wall_ms * 1e-3) / 1e12, flops_per_step=flops,
              idle_share=1 - device_ms / wall_ms,
              top=sorted(((round(t / 1e3, 4), k[:80]) for k, t in dev_us.items()),
                         reverse=True)[:8])
    log(f"[train] {arch} B={B} S={S}: {wall_ms:.2f} ms a step (median of steps 2-{n_steps}, "
        f"wall), {device_ms:.2f} ms of device time in {n_ev} kernels (one profiled step; idle "
        f"{100 * tr['idle_share']:.0f} %), optimizer {opt_ms:.2f} ms of device time (CUDA "
        f"events), {tr['optimizer_wall_ms']:.2f} ms wall; "
        f"{tr['tokens_per_s']:.0f} tokens/s, {tr['model_tflops']:.2f} TFLOP/s of model "
        f"work (6 N tokens = {flops / 1e12:.2f} TFLOP a step); peak memory "
        f"{tr['peak_mem_bytes'] / 1e9:.3f} GB; card: {smi}")
    for t_ms, nm in tr["top"]:
        log(f"[train]   {t_ms:.4f} ms  {nm}")
    del fresh, fresh_opt, grads
    torch.cuda.empty_cache()
    tr["phase_s"] = time.perf_counter() - t15
    log(f"[train] phase 15 took {tr['phase_s']:.1f} s")
    return tr


#: phase 16: the architectures whose every shape the meta sweep runs, the
#: hill-climb cell whose per-device program then runs on the card, and the
#: timed steps of 16b / 16c (after a counted step and a warm-up)
DRY_ARCHS = ("qwen3-0.6b", "deepseek-v2-lite-16b")
DRY_CELL = ("qwen3_train", "dp_only")
DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRY_STEPS = 5


class MetaSweep:
    """Phase 16a's meta sweep (``launch.dryrun`` for every shape of
    ``DRY_ARCHS``) and 16b's hill-climb record (``launch.hillclimb``), run
    as child processes in the background from the end of the build: a
    prefill_32k step traces for a few minutes of host time on ``meta``.
    Three lanes, one after another within a lane, on the machine's last
    three cores: each arch's prefill_32k, and the other shapes of both archs
    followed by the hill-climb cell.  The children see no card
    (``CUDA_VISIBLE_DEVICES`` empty) and write under ``out_dir``; ``stop``
    kills any still running (also at exit)."""

    def __init__(self, out_dir: Path):
        import atexit
        import os
        import threading

        self.dir = out_dir
        out_dir.mkdir(parents=True, exist_ok=True)
        for f in list(out_dir.glob("*.jsonl")) + list(out_dir.glob("*.log")):
            f.unlink()
        dry = [sys.executable, "-m", "repro_torch.launch.dryrun"]
        rest = ",".join(s for s in DRY_SHAPES if s != "prefill_32k")
        cell, it = DRY_CELL
        lanes = [[("prefill_" + a, dry + ["--arch", a, "--shape", "prefill_32k"])]
                 for a in DRY_ARCHS]
        lanes.append([("rest_" + a, dry + ["--arch", a, "--shape", rest]) for a in DRY_ARCHS]
                     + [("hillclimb", [sys.executable, "-m", "repro_torch.launch.hillclimb",
                                       "--cell", cell, "--iter", it])])
        self.env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
                        CUDA_VISIBLE_DEVICES="")
        cores = sorted(os.sched_getaffinity(0))
        self.cores = set(cores[-3:]) if len(cores) >= 6 else set(cores)
        self.procs, self.results, self.stopped = {}, {}, False
        self.t0 = time.perf_counter()
        self.threads = [threading.Thread(target=self._lane, args=(lane,), daemon=True)
                        for lane in lanes]
        for t in self.threads:
            t.start()
        atexit.register(self.stop)

    def _lane(self, lane) -> None:
        import os

        for name, cmd in lane:
            if self.stopped:
                return
            t0 = time.perf_counter()
            with open(self.dir / f"{name}.log", "w") as log_f:
                proc = subprocess.Popen(
                    cmd + ["--out", str(self.dir / f"{name}.jsonl")], cwd=REPO, env=self.env,
                    stdout=log_f, stderr=subprocess.STDOUT)
                # pinned from here: a preexec_fn is not safe beside threads
                try:
                    os.sched_setaffinity(proc.pid, self.cores)
                except ProcessLookupError:      # it has ended already
                    pass
                self.procs[name] = proc
                rc = proc.wait()
            self.results[name] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                                  "done_at_s": time.perf_counter() - self.t0}
            if rc:
                return

    def wait(self, timeout: float) -> dict:
        end = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(0.0, end - time.perf_counter()))
        if any(t.is_alive() for t in self.threads):
            self.stop()
            raise AssertionError(f"the meta sweep did not end within {timeout:.0f} s: "
                                 f"{self.results}")
        return self.results

    def stop(self) -> None:
        self.stopped = True
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def dryrun_phase(torch, dev, smi: str, sweep) -> dict:
    """Phase 16, the dry-run and roofline tools: (a) the meta sweep's cells
    (each ``ok`` or skipped for the reference's reason) and their roofline
    table on the H100 data sheet; (b) the hill-climb cell's record, then its
    per-device program on the card -- the counted matmul FLOPs times the
    devices equal to the record's, no counted kernel, every loss finite --
    with its times, peak memory and roofline shares; (c) one decode step of
    ``decode_32k`` at B = 1 on the card beside its counted bytes.  The LM
    steps reach no ``pallas_call`` in the reference, so no kernel of the nine
    runs here: the window checks that none is launched."""
    import math

    from repro_torch.kernels import cuda_build as CB
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch import hillclimb as HILL
    from repro_torch.launch import roofline as ROOF
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.registry import Model, get_config
    from repro_torch.configs import shape_applicable
    from repro_torch.utils.hw import H100
    from repro_torch.utils.op_flops import OpCounter
    from repro_torch.utils.tree import leaves

    t16 = time.perf_counter()
    dr = {"card": smi}

    # 16a. the meta sweep
    lanes = sweep.wait(timeout=900)
    dr["sweep_wait_s"] = time.perf_counter() - t16
    check(all(r["rc"] == 0 for r in lanes.values()) and len(lanes) == 2 * len(DRY_ARCHS) + 1,
          f"the meta sweep failed: {lanes}; logs under {sweep.dir}")
    recs = [json.loads(ln) for f in sorted(sweep.dir.glob("*.jsonl"))
            if f.name != "hillclimb.jsonl" for ln in f.read_text().splitlines()]
    sweep_path = sweep.dir / "dryrun.jsonl"
    sweep_path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    by_cell = {(r["arch"], r["shape"]): r for r in recs}
    for arch in DRY_ARCHS:
        for shape in DRY_SHAPES:
            r = by_cell.get((arch, shape))
            check(r is not None, f"the meta sweep has no record of {arch} x {shape}")
            ok, why = shape_applicable(get_config(arch), shape)
            if not ok:
                check(r["status"] == "skipped" and r["reason"] == why,
                      f"{arch} x {shape}: {r['status']}, not skipped for {why!r}")
                continue
            check(r["status"] == "ok", f"{arch} x {shape}: {r.get('error', r['status'])}")
            check(r["launches"] == 0 and r["collective_bytes_per_device"] is None
                  and r["memory"]["temp_bytes"] is None and r["collective_reason"]
                  and r["memory"]["temp_reason"],
                  f"{arch} x {shape}: a missing count reported as a number: {r}")
            log(f"[dryrun] {arch} x {shape} (meta, 16x16): traced in {r['trace_s']:.1f} s of "
                f"host time; {r['op_flops_global']:.6g} FLOPs ({r['op_matmul_flops_global']:.6g} "
                f"in products), {r['op_bytes_global'] / 1e12:.3f} TB eager, "
                f"{r['memory']['argument_bytes'] / 1e9:.3f} GB of arguments a device")
    dr["cells"] = {f"{a} x {s}": {k: by_cell[(a, s)].get(k) for k in
                                  ("status", "trace_s", "op_flops_global",
                                   "op_matmul_flops_global", "op_bytes_global",
                                   "flops_per_device", "model_flops", "memory", "reason")}
                   for a in DRY_ARCHS for s in DRY_SHAPES}
    dr["lanes"] = lanes
    table = ROOF.table_from_jsonl(str(sweep_path), chip=H100)
    dr["table"] = table
    lane_s = ", ".join(f"{k} {v['wall_s']:.1f} s" for k, v in lanes.items())
    log(f"[dryrun] the meta sweep: {len(recs)} cells in three background lanes "
        f"({lane_s}); "
        f"phase 16 waited {dr['sweep_wait_s']:.1f} s for it; roofline on the H100 data "
        f"sheet (989 TFLOP/s bf16, 3.35 TB/s, 25 GB/s a link), n/c = not counted:")
    for ln in table.splitlines():
        log(f"[roofline] {ln}")

    # 16b. the hill-climb record, then its per-device program on the card
    cell, it = DRY_CELL
    hill = [json.loads(ln) for ln in (sweep.dir / "hillclimb.jsonl").read_text().splitlines()]
    rec = hill[-1]
    check(rec["status"] == "ok" and rec["cell"] == cell and rec["iteration"] == it,
          f"hillclimb {cell}/{it}: {rec.get('error', rec['status'])}")
    ex = rec["extrap"]
    check(ex["flops_per_device_extrap"] == rec["flops_per_device"]
          and ex["bytes_per_device_extrap"] == rec["bytes_per_device"],
          f"the depth fit does not reproduce the full-depth count: {ex}")
    arch, shape = HILL.CELLS[cell]
    cfg = get_config(arch, **HILL.resolve_overrides(HILL.ITERS[it]))
    check(cfg.remat == "full" and cfg.compute_dtype == torch.bfloat16
          and rec["local_batch"] == 1 and rec["bytes_per_device"] is not None,
          f"{arch} {it}: remat {cfg.remat}, compute {cfg.compute_dtype}, local batch "
          f"{rec['local_batch']}, bytes {rec['bytes_per_device']}")
    n_dev = rec["n_devices"]
    model = Model(cfg)
    mesh = make_production_mesh()
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(gen, device=dev)
    fn, args, _, _ = DRY.build_step(model, shape, mesh, device=dev, batch=rec["local_batch"],
                                    params=params, generator=gen)
    CB.reset_launch_counts()
    with OpCounter() as oc:
        out = fn(*args)
    torch.cuda.synchronize()
    losses = [float(out[2]["loss"])]
    card = oc.counts
    check(card.matmul * n_dev == rec["op_matmul_flops_global"],
          f"{arch} {it}: the card's matmul FLOPs x {n_dev} = {card.matmul * n_dev} != the "
          f"meta record's {rec['op_matmul_flops_global']}")
    walls, dev_ms = [], []
    for i in range(DRY_STEPS + 1):             # the first is a warm-up
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.record()
        out = fn(*args)
        e.record()
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(s.elapsed_time(e))
        losses.append(float(out[2]["loss"]))
    dev_us, n_ev = device_split(torch, lambda: fn(*args), "the phase 16 step")
    check(card.launches == 0 and sum(CB.launch_counts().values()) == 0,
          f"counted kernels launched in the phase 16 step: {CB.launch_counts()}")
    check(all(math.isfinite(x) for x in losses), f"{arch} {it}: a non-finite loss {losses}")
    peak = torch.cuda.max_memory_allocated() - mem0
    params_t, opt_state, batch = args
    held = sum(t.numel() * t.element_size() for t in list(params_t.parameters())
               + list(opt_state["m"].values()) + list(opt_state["v"].values())
               + [opt_state["step"]] + list(batch.values()))
    opt_local = DRY.local_bytes(DRY.arg_shapes(model, shape)[1],
                                DRY.step_specs(model, shape, mesh)[1], mesh)
    step_ms = float(np.median(dev_ms))
    row = ROOF.analyse_record(rec, H100)
    mem_card_s = card.bytes / H100.hbm_bytes_per_s
    crit_s = max(row.compute_s, row.memory_s)
    crit_counted_s = max(row.compute_s, mem_card_s)
    tokens = rec["local_batch"] * 4096
    model_fl = 6 * rec["n_active_params"] * tokens
    dr["card_step"] = {
        "arch": arch, "cell": cell, "iteration": it, "batch": rec["local_batch"], "seq": 4096,
        "devices": n_dev, "matmul_flops": card.matmul, "flops": card.flops,
        "counted_bytes": card.bytes, "record_bytes_per_device": rec["bytes_per_device"],
        "record_flops_per_device": rec["flops_per_device"], "losses": losses,
        "device_ms": dev_ms, "device_ms_median": step_ms, "wall_ms": walls,
        "wall_ms_median": float(np.median(walls)), "peak_mem_bytes": peak,
        "held_bytes": held, "record_argument_bytes": rec["memory"]["argument_bytes"],
        "record_opt_local_bytes": opt_local, "compute_ms": row.compute_s * 1e3,
        "memory_analytic_ms": row.memory_s * 1e3,
        "memory_counted_ms": mem_card_s * 1e3,
        "memory_counted_meta_ms": row.memory_s_counted * 1e3, "bound": row.bound,
        "critical_share": crit_s / (step_ms * 1e-3),
        "critical_counted_share": crit_counted_s / (step_ms * 1e-3),
        "model_flops": model_fl,
        "model_tflops": model_fl / (step_ms * 1e-3) / 1e12,
        "mfu": model_fl / (step_ms * 1e-3) / H100.peak_flops_bf16,
        "kernels": n_ev, "busy_ms": sum(dev_us.values()) / 1e3,
        "idle_share": 1 - sum(dev_us.values()) / 1e3 / step_ms,
        "top": sorted(((round(t / 1e3, 4), k[:80]) for k, t in dev_us.items()),
                      reverse=True)[:8]}
    cs = dr["card_step"]
    log(f"[dryrun] {cell}/{it} record ({n_dev} devices, mesh {rec['mesh']}): "
        f"{rec['op_flops_global']:.6g} FLOPs global ({rec['op_matmul_flops_global']} in "
        f"products), {rec['flops_per_device']:.6g} a device, {rec['bytes_per_device'] / 1e9:.3f} "
        f"GB eager a device at B = {rec['local_batch']} (meta), arguments "
        f"{rec['memory']['argument_bytes'] / 1e9:.3f} GB a device; depth fit = the count")
    log(f"[dryrun] {arch} per-device step on the card (B = {cs['batch']}, S = 4096, remat "
        f"full, bf16 compute, f32 parameters and AdamW state whole): matmul FLOPs "
        f"{card.matmul} x {n_dev} = the record's, exactly; no counted kernel; losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    log(f"[dryrun] step {step_ms:.2f} ms of device time (CUDA events, median of "
        f"{DRY_STEPS}; {' '.join(f'{x:.2f}' for x in dev_ms)}), wall {cs['wall_ms_median']:.2f} "
        f"ms; peak memory {peak / 1e9:.3f} GB beside {held / 1e9:.3f} GB of arguments the card "
        f"holds (the record's {rec['memory']['argument_bytes'] / 1e9:.3f} GB of ZeRO-1 "
        f"shards - {opt_local / 1e9:.3f} GB of opt-state shard + the opt state whole); "
        f"card: {smi}")
    log(f"[dryrun] H100 roofline of the step: compute {cs['compute_ms']:.2f} ms at 989 "
        f"TFLOP/s ({card.flops:.6g} counted FLOPs); memory {cs['memory_analytic_ms']:.2f} ms "
        f"analytic, {cs['memory_counted_ms']:.2f} ms counted on the card "
        f"({card.bytes / 1e9:.3f} GB eager; meta {cs['memory_counted_meta_ms']:.2f} ms) at "
        f"3.35 TB/s; bound {row.bound}; the critical term is {100 * cs['critical_share']:.1f} % "
        f"of the measured step ({100 * cs['critical_counted_share']:.1f} % with the counted "
        f"bytes); model work 6 N tokens = {model_fl / 1e12:.3f} TFLOP, "
        f"{cs['model_tflops']:.2f} TFLOP/s = {100 * cs['mfu']:.2f} % of 989; card: {smi}")
    log(f"[dryrun] one profiled step: {cs['busy_ms']:.2f} ms of device time in {n_ev} "
        f"kernels, idle {100 * cs['idle_share']:.1f} % of the {step_ms:.2f} ms step; card: {smi}")
    for t_ms, nm in cs["top"]:
        log(f"[dryrun]   {t_ms:.4f} ms  {nm}")
    del out, fn, args, params_t, opt_state, batch
    torch.cuda.empty_cache()

    # 16c. one decode step of decode_32k at B = 1 against a full cache
    fn, args, _, _ = DRY.build_step(model, "decode_32k", mesh, device=dev, batch=1,
                                    params=params, generator=gen)
    CB.reset_launch_counts()
    with OpCounter() as oc:
        logits, _ = fn(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (1, cfg.vocab),
          f"decode_32k: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    p_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
    c_bytes = sum(t.numel() * t.element_size() for t in leaves(args[1]))
    d_ms = time_ms(torch, lambda: fn(*args), reps=10)
    check(oc.counts.launches == 0 and sum(CB.launch_counts().values()) == 0,
          f"counted kernels launched in the decode step: {CB.launch_counts()}")
    bound = (p_bytes + c_bytes) / H100.hbm_bytes_per_s * 1e3
    dr["decode"] = {"batch": 1, "cache_len": 32768, "cache_dtype": str(cfg.cache_dtype),
                    "param_bytes": p_bytes, "cache_bytes": c_bytes,
                    "counted_bytes": oc.counts.bytes, "counted_flops": oc.counts.flops,
                    "bound_ms": bound, "counted_bound_ms":
                        oc.counts.bytes / H100.hbm_bytes_per_s * 1e3,
                    "device_ms": d_ms, "bound_share": bound / d_ms}
    dd = dr["decode"]
    log(f"[dryrun] {arch} decode_32k at B = 1 (32,768-token {cfg.cache_dtype} cache, f32 "
        f"parameters): {d_ms:.3f} ms of device time (CUDA events, median of 10); params "
        f"{p_bytes / 1e9:.3f} GB + cache {c_bytes / 1e9:.3f} GB = {bound:.3f} ms at 3.35 TB/s "
        f"({100 * dd['bound_share']:.1f} % of the step); the eager step moves "
        f"{oc.counts.bytes / 1e9:.3f} GB (counted; {dd['counted_bound_ms']:.3f} ms); card: {smi}")
    del fn, args, params, logits
    torch.cuda.empty_cache()
    dr["phase_s"] = time.perf_counter() - t16
    log(f"[dryrun] phase 16 took {dr['phase_s']:.1f} s")
    return dr


#: phase 17: the 3-D Laplacian's side (112^3 = 1,404,928 rows) and the
#: ~100M training run's steps (cut from the example's 300)
EX_NX = 112
EX_TRAIN_STEPS = 60

#: the CUDA kernels a plan of each format launches once a call
FORMAT_KERNELS = {"csr": ("csr_spmv",), "sell": ("sell_spmv",),
                  "hybrid": ("dia_spmv", "sell_spmv"), "matrix_free": ("mf_spmv",)}


def examples_phase(torch, dev, smi: str, n: int) -> dict:
    """Phase 17, the ``repro_torch.examples`` at the paper's scale
    (the module docstring lists its checks).  Each ``main()`` runs with the
    launch counters set to 0 just before it and read just after; the counts
    it must show are derived from the calls the example makes.  Returns the
    phase's record, ``launches`` summed over the examples."""
    from repro_torch.core import formats as F
    from repro_torch.core import microbench as MB
    from repro_torch.core.eigensolver import lanczos
    from repro_torch.core.plan import SpMVPlan
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.examples import (distributed_spmv, eigensolver_holstein,
                                      matrix_free_laplacian, quickstart, serve_sparse,
                                      serving_load, train_lm)
    from repro_torch.kernels import cuda_build as CB

    t17 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # dense f32 references in full f32
    devarg = ["--device", str(dev)]
    ex = {"launches": {}}

    def run(name, mod, argv):
        """``mod.main(argv)`` between two reads of the launch counters:
        (result, counts, host seconds)."""
        CB.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mod.main(argv + devarg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in CB.launch_counts().items() if v}
        for k, v in counts.items():
            ex["launches"][k] = ex["launches"].get(k, 0) + v
        log(f"[examples] {name} {' '.join(argv)}: {secs:.1f} s, launches {counts}")
        return res, counts, secs

    def expect(counts, want, what):
        got = {k: v for k, v in counts.items() if k in CB.KERNELS}
        check(got == {k: v for k, v in want.items() if v},
              f"{what}: counted launches {got}, expected {want}")

    def host_product(m, x):
        """The f64 product m @ x of a CSR container on the host."""
        rp, ci = F._np(m.row_ptr).astype(np.int64), F._np(m.col_idx)
        rows = np.repeat(np.arange(m.shape[0]), np.diff(rp))
        xv = x.detach().double().cpu().numpy()
        return torch.from_numpy(np.bincount(rows, weights=F._np(m.val).astype(np.float64)
                                            * xv[ci], minlength=m.shape[0]))

    def against_host(what, y, want):
        _, rel = rel_err(torch, y.cpu(), want)
        tol = TOL[str(y.dtype).removeprefix("torch.")]
        check(bool(torch.isfinite(y).all()) and rel <= tol,
              f"{what}: {rel:.3e} from the host f64 product (bound {tol:g})")
        return rel

    def normwise(a, b) -> float:
        return float(np.max(np.abs(a - b)) / max(1e-300, np.max(np.abs(b))))

    def slabs(plan) -> int:
        return sum(op is not None for row in plan.operands for op in row)

    def tally(plan, calls, want):
        for k in FORMAT_KERNELS.get(plan.report.format, ()) if plan.report.kernel == "cuda" \
                else ():
            want[k] = want.get(k, 0) + calls

    # 17a. quickstart: advisor -> plan -> SpMV -> 48 Lanczos steps
    qs, counts, secs = run("quickstart", quickstart, ["--n", str(n)])
    plan = qs["plan"]
    check(plan.report.kernel == "cuda", f"quickstart: the plan runs {plan.report.kernel}")
    want = {}
    tally(plan, 1 + qs["lanczos"].n_spmv, want)
    expect(counts, want, "quickstart")
    rel_y = against_host("quickstart plan(x)", qs["y"], host_product(qs["matrix"], qs["x"]))
    ref = lanczos(SpMVPlan.compile(plan.matrix, PlanConfig(backend="torch", device=dev)), n, m=48,
                  dtype=torch.float32)
    da, db = normwise(qs["lanczos"].alphas, ref.alphas), normwise(qs["lanczos"].betas, ref.betas)
    check(qs["lanczos"].alphas.shape == ref.alphas.shape and da <= 1e-6 and db <= 1e-6,
          f"quickstart: Lanczos through the kernels differs from the torch entry "
          f"(alpha {da:.2e}, beta {db:.2e} of their max)")
    ex["quickstart"] = {"s": secs, "best": qs["best"], "format": plan.report.format,
                        "launches": counts, "rel_err": rel_y, "e0": qs["e0"],
                        "alpha_rel_diff": da, "beta_rel_diff": db}
    log(f"[examples] quickstart: advisor -> {qs['best']}, plan {plan.report.format}/"
        f"{plan.report.kernel}, plan(x) {rel_y:.2e} from f64; E0 {qs['e0']:.6f}; "
        f"vs torch entry alpha {da:.1e}, beta {db:.1e}")
    del qs, plan, ref

    # 17b. eigensolver_holstein: exact check, shoot-out, Lanczos, distributed
    eg, counts, secs = run("eigensolver_holstein", eigensolver_holstein,
                           ["--n", str(n), "--lanczos-steps", "64"])
    exact = eg["exact"]
    check(abs(exact["e0"] - exact["e_dense"]) <= 1e-5,
          f"exact L = 3: E0 {exact['e0']!r} vs dense {exact['e_dense']!r}")
    y_host = host_product(eg["matrix"], eg["x"])
    want, fmts = {}, {}
    for name, row in eg["shootout"].items():
        tally(row["plan"], eigensolver_holstein.ITERS + 1, want)
        fmts[name] = {"ms": row["seconds"] * 1e3, "gflops": row["gflops"],
                      "kernel": row["kernel"], "convert_s": row["convert_s"],
                      "rel_err": against_host(f"eigensolver {name} plan(x)",
                                              row["plan"](eg["x"]), y_host)}
    best = eg["shootout"][eg["best"]]["plan"]
    tally(best, eg["lanczos"].n_spmv + 1, want)  # the solve, and y_serial
    want["sell_spmv"] = want.get("sell_spmv", 0) + slabs(eg["dist"]) * (
        eg["dist"].slab_backend == "cuda")
    expect(counts, want, "eigensolver_holstein")
    ref = lanczos(SpMVPlan.compile(best.matrix, PlanConfig(backend="torch", device=dev)), n,
                  m=64,
                  dtype=torch.float32)
    de0 = abs(eg["e0"] - float(ref.eigenvalues[0])) / abs(float(ref.eigenvalues[0]))
    check(de0 <= 1e-6, f"eigensolver: the winner's E0 {eg['e0']!r} vs the torch entry's "
                       f"{float(ref.eigenvalues[0])!r}")
    check(eg["dist_rel_err"] <= 1e-5, f"eigensolver: distributed plan {eg['dist_rel_err']:.2e} "
                                      "from the serial plan")
    ex["eigensolver_holstein"] = {
        "s": secs, "exact": exact, "formats": fmts, "best": eg["best"], "launches": counts,
        "e0": eg["e0"], "e0_rel_diff_vs_torch": de0, "lanczos_s": eg["lanczos_s"],
        "spmv_share": eg["spmv_share"], "dist_parts": eg["dist"].parts,
        "dist_rel_err": eg["dist_rel_err"]}
    log(f"[examples] eigensolver_holstein at N={n}: " + ", ".join(
        f"{k} {v['gflops']:.2f} GFLOP/s ({v['ms']:.4f} ms, {v['kernel']}, converted "
        f"{v['convert_s']:.2f} s)" for k, v in fmts.items()) + f"; winner {eg['best']}: "
        f"E0 {eg['e0']:.6f} in {eg['lanczos_s']:.3f} s, SpMV share "
        f"{100 * eg['spmv_share']:.1f} %; distributed {eg['dist'].parts} shard(s) "
        f"{eg['dist_rel_err']:.1e} from serial; card: {smi}")
    del eg, best, ref, y_host

    # 17c. matrix_free_laplacian: the card calibrates anew, as a user's
    # process does (card_chip() measures through kernel 8)
    MB._CAL.clear()
    mf, counts, secs = run("matrix_free_laplacian", matrix_free_laplacian,
                           ["--nx", str(EX_NX)])
    check(torch.equal(F.materialize(mf["op"]).val, mf["matrix"].val),
          "matrix_free: materialize is not bitwise the assembled CSR")
    calls = {"csr": mf["iters"] + 2, "matrix_free": mf["iters"] + 2 + mf["lanczos"].n_spmv}
    want = {}
    for k, p_ in mf["plans"].items():
        tally(p_, calls[k], want)
    check(counts.get("stream_triad", 0) > 0, "matrix_free: card_chip() did not calibrate")
    want["stream_triad"] = counts.get("stream_triad", 0)
    expect(counts, want, "matrix_free_laplacian")
    y_host = host_product(mf["matrix"], mf["x"])
    host_rel = {k: against_host(f"matrix_free_laplacian {k} plan(x)", p_(mf["x"]), y_host)
                for k, p_ in mf["plans"].items()}
    check(mf["parity_rel_err"] <= 1e-5, f"matrix_free vs csr plan: {mf['parity_rel_err']:.2e}")
    ex["matrix_free_laplacian"] = {
        "s": secs, "rows": mf["matrix"].shape[0], "nnz": mf["matrix"].nnz,
        "launches": counts, "host_rel_err": host_rel, "model_bytes_per_nnz": mf["bytes_per_nnz"],
        "moved_bytes_per_nnz": mf["moved_per_nnz"],
        "ms": {k: v * 1e3 for k, v in mf["seconds"].items()},
        "triad_bytes_per_s": mf["chip"].hbm_bytes_per_s, "rel_err": mf["parity_rel_err"],
        "e0": mf["e0"], "lanczos_s": mf["lanczos_s"]}
    rec = ex["matrix_free_laplacian"]
    log(f"[examples] matrix_free_laplacian {EX_NX}^3 ({rec['rows']:,} rows): csr "
        f"{rec['ms']['csr']:.4f} ms = {rec['moved_bytes_per_nnz']['csr']:.2f} B/nnz (model "
        f"{rec['model_bytes_per_nnz']['csr']:.2f}), matrix_free {rec['ms']['matrix_free']:.4f} "
        f"ms = {rec['moved_bytes_per_nnz']['matrix_free']:.2f} B/nnz (model "
        f"{rec['model_bytes_per_nnz']['matrix_free']:.2f}) at the triad rate "
        f"{rec['triad_bytes_per_s'] / 1e12:.4f} TB/s; from the host f64 product: csr "
        f"{host_rel['csr']:.2e}, matrix_free {host_rel['matrix_free']:.2e}; E0 {mf['e0']:.6f}")
    del mf, y_host

    # 17d. distributed_spmv: the three variants, one shard a visible card
    ds, counts, secs = run("distributed_spmv", distributed_spmv, ["--n", str(n)])
    want = {"sell_spmv": 0}
    for v, row in ds["variants"].items():
        check(row["rel_err"] <= 1e-5, f"distributed_spmv {v}: {row['rel_err']:.2e} from csr")
        if row["plan"].slab_backend == "cuda":
            want["sell_spmv"] += slabs(row["plan"]) * (distributed_spmv.ITERS + 1
                                                       + 60 * (v == "overlap"))
    expect(counts, want, "distributed_spmv")
    ex["distributed_spmv"] = {
        "s": secs, "shards": len(ds["mesh"].devices), "launches": counts, "e0": ds["e0"],
        "variants": {v: {"ms": r["seconds"] * 1e3, "rel_err": r["rel_err"],
                         "slab": r["plan"].slab_format, "backend": r["plan"].slab_backend}
                     for v, r in ds["variants"].items()}}
    log(f"[examples] distributed_spmv at N={n}, {len(ds['mesh'].devices)} shard(s): " +
        ", ".join(f"{v} {r['ms']:.4f} ms ({r['slab']}/{r['backend']}, {r['rel_err']:.1e})"
                  for v, r in ex["distributed_spmv"]["variants"].items()) +
        f"; E0 {ds['e0']:.6f}")
    del ds

    # 17e. serve_sparse --full: Qwen3-0.6B's gate through its kernel, then
    # the engine
    sv, counts, secs = run("serve_sparse", serve_sparse, ["--full"])
    gate = sv["gate"]
    kname = "bell_spmm" if gate["layer"].fmt == "bsr" else "sell_spmm"
    check(gate["w_sparse"].shape == (3072, 1024), f"serve_sparse: gate {gate['w_sparse'].shape}")
    expect(counts, {kname: 1}, "serve_sparse")
    check(gate["rel_err"] <= 1e-5, f"serve_sparse: layer {gate['rel_err']:.2e} from dense")
    wave = sv["engine"].generate(sv["prompts"], sv["gen_cfg"])
    check(wave == sv["outs"] and all(len(o) == 12 for o in wave),
          f"serve_sparse: a second wave gave {wave}, the first {sv['outs']}")
    ex["serve_sparse"] = {"s": secs, "fmt": gate["layer"].fmt, "kernel": kname,
                          "launches": counts, "rel_err": gate["rel_err"],
                          "streamed_bytes": gate["streamed_bytes"], "tokens": sv["outs"],
                          "decode_bytes_per_token": sv["decode_bytes_per_token"]}
    log(f"[examples] serve_sparse --full: gate {gate['report']['advised_format']} -> "
        f"{kname} once, {gate['rel_err']:.1e} from dense, {gate['streamed_bytes'] / 1e6:.3f} "
        f"MB/SpMV; two waves equal; {sv['decode_bytes_per_token'] / 1e9:.4f} GB a token")
    del sv, gate
    torch.cuda.empty_cache()

    # 17f. serving_load: heavy and thin open-loop traffic through kernel 5
    sl, counts, secs = run("serving_load", serving_load, ["--n", str(n)])
    runs = {"heavy": sl["heavy"], "thin": sl["thin"]}
    check(all(r["width"] > 1 for r in runs.values()), "serving_load: width 1 serves no SpMM")
    expect(counts, {"sell_spmm": sum(r["stats"]["batches"] for r in runs.values())},
           "serving_load")
    for name, r in runs.items():
        plan = r["server"].plan(name)
        worst = max(rel_err(torch, f.result(), plan(x))[1]
                    for f, x in zip(r["futures"], sl["xs"]))
        check(worst <= TOL["float32"], f"serving_load {name}: a future {worst:.2e} from plan(x)")
        r["worst_rel_err"] = worst
    check(runs["heavy"]["stats"]["mean_batch_width"] > runs["thin"]["stats"]["mean_batch_width"]
          and runs["thin"]["stats"]["padding_ratio"] > runs["heavy"]["stats"]["padding_ratio"],
          "serving_load: the reference's assertions")
    # the heavy run again on the same container, its SpMM operand already
    # derived: the example's rate is a cold server's
    warm = serving_load.run_load("heavy", 50_000, 240, 2e-3, sl["matrix"], sl["xs"],
                                 device=dev)
    ex["serving_load"] = {"s": secs, "launches": counts, **{
        name: {k: r["stats"][k] for k in ("requests", "batches", "mean_batch_width",
                                          "padding_ratio", "batch_width")}
        | {"p50_ms": r["p50"] * 1e3, "p95_ms": r["p95"] * 1e3, "wall_s": r["wall_s"],
           "req_per_s": r["req_per_s"], "worst_rel_err": r["worst_rel_err"]}
        for name, r in runs.items()}, "heavy_again_req_per_s": warm["req_per_s"]}
    log("[examples] serving_load at N=%d: " % n + "; ".join(
        f"{k} width {v['batch_width']}, {v['batches']} flushes, mean {v['mean_batch_width']:.2f},"
        f" padding {v['padding_ratio']:.2f}, p50/p95 {v['p50_ms']:.2f}/{v['p95_ms']:.2f} ms "
        f"(virtual), {v['req_per_s']:.0f} req/s wall" for k, v in ex["serving_load"].items()
        if k in runs) + f"; heavy again {warm['req_per_s']:.0f} req/s wall; card: {smi}")
    del sl, runs, warm
    torch.cuda.empty_cache()

    # 17g. train_lm: the ~100M config, EX_TRAIN_STEPS steps
    ckpt = REPO / "build" / "train_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        tr, counts, secs = run("train_lm", train_lm, ["--steps", str(EX_TRAIN_STEPS),
                                                     "--ckpt-dir", str(ckpt)])
        ckpt_steps = sorted(int(d.name.split("_")[-1]) for d in ckpt.iterdir()
                            if d.name.split("_")[-1].isdigit())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = tr["losses"]
    check(tr["step"] == EX_TRAIN_STEPS and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train_lm: losses {losses} at step {tr['step']}")
    expect(counts, {}, "train_lm")
    step_s = float(np.median([dt for _, _, dt in tr["loop"].history]))
    tokens = tr["loop"].data_iter.cfg.global_batch * tr["loop"].data_iter.cfg.seq_len
    ex["train_lm"] = {"s": secs, "params": tr["model"].total_params(), "losses": losses,
                      "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
                      "ckpt_steps": ckpt_steps}
    log(f"[examples] train_lm {tr['model'].total_params() / 1e6:.1f}M params, "
        f"{EX_TRAIN_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"{step_s * 1e3:.1f} ms a logged step (wall, median), {tokens / step_s:.0f} tokens/s; "
        f"checkpoints at steps {ckpt_steps} (deleted); card: {smi}")
    del tr
    torch.cuda.empty_cache()

    ex["phase_s"] = time.perf_counter() - t17
    log(f"[examples] phase 17 took {ex['phase_s']:.1f} s; launches {ex['launches']}")
    return ex


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_201_200,
                    help="surrogate rows (the paper's N = 1,201,200)")
    ap.add_argument("--lanczos-steps", type=int, default=64)
    ap.add_argument("--triad-n", type=int, default=1 << 26,
                    help="STREAM-triad elements per array")
    ap.add_argument("--micro-n", type=int, default=1 << 22,
                    help="accesses of the Table-1 and gather-split kernels")
    ap.add_argument("--laplace", type=int, default=1100, help="laplacian_2d side")
    ap.add_argument("--exact-L", type=int, default=6,
                    help="chain sites of the exact Holstein-Hubbard operator of phases 2d, 4c, 7")
    ap.add_argument("--exact-phonon", type=int, default=5,
                    help="its phonon cutoff (L = 6, 5: 1,679,616 rows, the paper's scale)")
    ap.add_argument("--hmep-cap", type=int, default=8,
                    help="phonons in total (and on a site) of phase 4d's exact HMeP "
                         "(8: N = 1,201,200)")
    ap.add_argument("--powerlaw-n", type=int, default=1 << 20,
                    help="rows of the power-law matrix of phase 7")
    ap.add_argument("--gemma-ff", type=int, default=24576,
                    help="SparseLinear d_out (Gemma-7B d_ff)")
    ap.add_argument("--gemma-model", type=int, default=3072,
                    help="SparseLinear d_in (Gemma-7B d_model)")
    ap.add_argument("--moe-experts", type=int, default=64,
                    help="routed experts (DeepSeek-V2-Lite)")
    ap.add_argument("--moe-d", type=int, default=2048, help="expert d_in (d_model)")
    ap.add_argument("--moe-f", type=int, default=1408, help="expert d_out (moe d_ff)")
    ap.add_argument("--moe-tokens", type=int, default=2048,
                    help="tokens of the serving batch (x 6 routed rows each)")
    ap.add_argument("--bsr-n", type=int, default=8192,
                    help="side of the block-sparse matrix of the bsr plan path")
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
        from repro_torch.core import corpus as CORPUS
        from repro_torch.core import distributed as DIST
        from repro_torch.core import distributed_plan as DP
        from repro_torch.core import formats as F
        from repro_torch.core import io as IO
        from repro_torch.core import matrices as M
        from repro_torch.core import tunedb as TDB
        from repro_torch.core import validate as V
        from repro_torch.core import microbench as MB
        from repro_torch.core import perfmodel as PM
        from repro_torch.core.eigensolver import LanczosBreakdown, lanczos
        from repro_torch.core.plan import SpMVPlan, _convert_cached
        from repro_torch.core.planconfig import PlanConfig
        from repro_torch.kernels import cuda_build as CB
        from repro_torch.kernels import registry as R
        from repro_torch.kernels import csr, csr_spmv, dia, dia_spmv, matrix_free
        from repro_torch.kernels import gather_bench as GB
        from repro_torch.kernels import ops as KOPS
        from repro_torch.kernels import sell, sell_spmv
        from repro_torch.interop import expert_weights
        from repro_torch.kernels.bsr_spmm import (
            bell_fill_ratio, bell_launch, bell_row_nblocks, bell_scale, bell_spmm_arrays,
            bell_spmm_plain, bsr_to_bell)
        from repro_torch.kernels.moe_gemm import (
            gemm_plan, grouped_gemm_arrays, grouped_gemm_plain, plan_groups)
        from repro_torch.models.sparse import (
            SparseLinear, advise_weight_format, magnitude_prune)
        from repro_torch import serve as SERVE
        from repro_torch.testing import faults
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
    log(f"[build] {len(CB.SOURCES)} kernel libraries ({len(CB.KERNELS)} kernels) in "
        f"{out['build_s']:.1f} s (nvcc, sm_90a)")
    # every instantiation of the kernels redesigned last below, the rest here
    ptxas_of = ("sell_spmv", "gather_bench", "sell_spmm", "bell_spmm")
    for name in (nm for nm in CB.SOURCES if nm not in ptxas_of):
        regs = [ln.strip() for ln in CB.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln and "0 bytes" not in ln]
        log(f"[ptxas] {name}: " + ("; ".join(regs[:2]) if regs else "(cached build)"))
    # phase 16's meta sweep runs beside phases 2-15, on cores of its own
    meta_sweep = MetaSweep(REPO / "chiprun_out" / "phase16")
    out["ptxas"] = {name: ptxas_entries(CB.build_log(name)) for name in ptxas_of}
    for name, ents in out["ptxas"].items():
        for ent in ents:
            log(f"[ptxas] {name}: {ent['entry'][:72]}: {ent['registers']} registers, "
                f"{ent['smem']} bytes smem, {ent['spill_stores']} / {ent['spill_loads']} "
                "bytes spill stores / loads")

    # --- matrices, built once -------------------------------------------------
    t0 = time.perf_counter()
    m = M.holstein_hubbard_surrogate(args.n, seed=0)
    hyb = F.split_dia(m)
    sell128 = F.SELL.from_csr(m, C=128)
    lap_csr = M.laplacian_2d(args.laplace, args.laplace)
    lap = F.MatrixFreeOperator.from_csr(lap_csr)
    exact_csr = M.holstein_hubbard_exact()
    exact = F.MatrixFreeOperator.from_csr(exact_csr)
    out["host_prep_s"] = time.perf_counter() - t0
    # the exact operator at the paper's scale: its host build is what a user
    # of the exact path waits for before the first SpMV
    t0 = time.perf_counter()
    ex6_csr = M.holstein_hubbard_exact(M.HolsteinHubbardParams(
        L=args.exact_L, max_phonon=args.exact_phonon))
    t1 = time.perf_counter()
    ex6 = F.MatrixFreeOperator.from_csr(ex6_csr)
    ex6_name = f"exact L={args.exact_L} max_phonon={args.exact_phonon}"
    out["exact_big_build_s"] = {"csr": t1 - t0, "from_csr": time.perf_counter() - t1}
    log(f"[matrices] surrogate N={m.shape[0]} nnz={m.nnz}; DIA part "
        f"{hyb.dia.offsets.shape[0]} diagonals, SELL rest nnz={hyb.rest.nnz} "
        f"({hyb.rest.n_chunks} chunks of C={hyb.rest.C}); laplacian "
        f"{lap.shape[0]} rows, {lap.n_generated} generated diagonals; exact "
        f"L=4 dim {exact.shape[0]} ({exact.n_stored} stored, {exact.n_generated} "
        f"generated lanes); host preprocessing {out['host_prep_s']:.1f} s; {ex6_name} dim "
        f"{ex6.shape[0]}, nnz {ex6_csr.nnz} ({ex6.n_stored} stored, {ex6.n_generated} "
        f"generated lanes), built in {out['exact_big_build_s']['csr']:.1f} s + from_csr "
        f"{out['exact_big_build_s']['from_csr']:.1f} s")

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
        blocks = sell.sell_chunk_blocks(s)
        n, C = s.shape[0], s.C
        args_ = (cp, cw, col, val, scale, perm, x, n, C)
        k = lambda: sell_spmv.sell_spmv_arrays(*args_, blocks)  # noqa: E731
        p = lambda: sell_spmv.sell_spmv_plain(*args_, seg)  # noqa: E731
        got = k()
        err = compare("sell_spmv", what, got, p())
        check(torch.equal(got, k()), f"sell_spmv {what}: two calls differ (no atomics: "
                                     "the sums have a fixed order)")
        base = torch.from_numpy(np.random.default_rng(3).standard_normal(n)).to(dev, got.dtype)
        into = base.clone()
        added = sell_spmv.sell_spmv_arrays(*args_, blocks, add_to=into)
        check(added is into and torch.equal(added, base + got),
              f"sell_spmv {what}: add_to is not base + y, in place")
        if timed:
            acc = str(got.dtype).replace("torch.", "")
            lib = csr_tensor(torch, *sell_triplets(F, s), s.shape, dev)
            xl = x.double()
            b, by = bound_ms(H100, nbytes(cp, cw, col, val, scale, perm, x)
                             + n * x.element_size(), 2 * s.nnz, acc)
            t = time_ms(torch, k)
            # every stored slot gathers one value of x (from L2: x fits)
            gather = col.numel() * x.element_size()
            record("sell_spmv", route="cuda", source="src/repro_torch/csrc/sell_spmv.cu",
                    replaces="src/repro/kernels/sell_spmv.py:79", max_abs_err=err,
                    ms=t, plain_ms=time_ms(torch, p), bound_ms=b,
                    bound_by=by, library_ms=time_ms(torch, lambda: lib @ xl),
                    gather_bytes=gather, gather_tb_s=gather / (t * 1e-3) / 1e12,
                    chunk_blocks=blocks.n_blocks,
                    shape=f"hybrid SELL rest, C={C}, {s.nnz} nnz, {blocks.n_blocks} chunk "
                          f"blocks of <= {sell_spmv.SELL_BUDGET} slots, val f32, x f64")
            log(f"[sell] kernel 1 {t:.4f} ms, bound {b:.4f} by {by}; x gathers "
                f"{gather / 1e6:.1f} MB ({col.numel()} slots x {x.element_size()} B) at "
                f"{gather / (t * 1e-3) / 1e12:.3f} TB/s; {blocks.n_blocks} chunk blocks")

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
        blocks = csr.csr_row_blocks(c)
        k = lambda: csr_spmv.csr_spmv_arrays(rp, col, val, scale, x, blocks)  # noqa: E731
        p = lambda: csr_spmv.csr_spmv_plain(rp, col, val, scale, x, rid)  # noqa: E731
        got = k()
        err = compare("csr_spmv", what, got, p())
        check(torch.equal(got, k()), f"csr_spmv {what}: two calls differ (no atomics: "
                                     "the sums have a fixed order)")
        if timed:
            acc = str(got.dtype).replace("torch.", "")
            # cuSPARSE on f64 values (the kernel's first yardstick) and on
            # the kernel's own bytes: f32 values, f32 x
            lib = torch.sparse_csr_tensor(rp.long(), col.long(), val.double(),
                                          size=c.shape)
            lib32 = torch.sparse_csr_tensor(rp.long(), col.long(), val.float(),
                                            size=c.shape)
            xl, xf = x.double(), x.float()
            b, by = bound_ms(H100, nbytes(rp, col, val, scale, x)
                             + c.n_rows * x.element_size(), 2 * c.nnz, acc)
            nb = blocks.n_blocks
            record("csr_spmv", route="cuda", source="src/repro_torch/csrc/csr_spmv.cu",
                    replaces="src/repro/kernels/csr_spmv.py:73", max_abs_err=err,
                    ms=time_ms(torch, k), plain_ms=time_ms(torch, p), bound_ms=b,
                    bound_by=by, library_ms=time_ms(torch, lambda: lib @ xl),
                    library_f32_ms=time_ms(torch, lambda: lib32 @ xf),
                    row_blocks=nb,
                    shape=f"full surrogate, {c.nnz} nnz, {nb} row blocks of <= "
                          f"{csr_spmv.CSR_BUDGET} nnz, val f32, x f64 (library: "
                          "cuSPARSE f64 val + f64 x; library_f32: f32 val + f32 x)")

    csr_case(m, x64, "full surrogate f32 val, f64 x", timed=True)
    for vd in VALUE_DTYPES:
        cv = F.with_value_dtype(m, vd)
        x = x64 if vd == "f64" else x64.float()
        csr_case(cv, x, f"full surrogate {vd} val, {x.dtype}".replace("torch.", ""))

    # --- 2d. matrix-free: laplacian_2d(1100, 1100), exact L = 4 and L = 6 -------
    mf_timed = {}

    def mf_case(op, x, what, timed=None, lib_csr=None):
        """Kernel 4 on its MfLaunch against the plain version on the padded x,
        on the lanes as the plan reads them (their codes where they code)
        and streamed, the two bit-equal, two calls bit-equal; ``timed``
        names a shape whose kernel (both forms), plain, cuSPARSE and
        plan-call times are kept."""
        launch = matrix_free.mf_launch(op)
        data, tab = on(matrix_free.mf_data(op)), launch.on(dev)
        lanes = matrix_free.mf_encode(data, launch) or data
        coded = lanes is not data
        p0, p1 = launch.pads
        acc = torch.float64 if torch.float64 in (x.dtype, data.dtype) else torch.float32
        xp = dia_spmv.pad_x(x, p0, p1, acc)
        nn = op.shape[0]
        k = lambda: matrix_free.mf_spmv_arrays(lanes, launch, x)  # noqa: E731
        ks = lambda: matrix_free.mf_spmv_arrays(data, launch, x)  # noqa: E731
        p = lambda: matrix_free.mf_spmv_plain(  # noqa: E731
            data, launch.desc, launch.gen, xp, p0, nn)
        got = k()
        err = compare("mf_spmv", what, got, p())
        check(torch.equal(got, k()), f"mf_spmv {what}: two calls differ (one accumulator a "
                                     "row, a fixed order)")
        check(torch.equal(got, ks()), f"mf_spmv {what}: codes and streamed lanes differ")
        if timed:
            lib = csr_tensor(torch, F._np(lib_csr.to_coo().rows).astype(np.int64),
                             F._np(lib_csr.col_idx).astype(np.int64),
                             F._np(lib_csr.val), lib_csr.shape, dev)
            xl = x.double()
            # lanes (or codes and their table), descriptor and x read once, y
            # written once
            tail = nbytes(tab, x) + nn * got.element_size()
            nb = tail + (nbytes(lanes.codes, lanes.values) if coded else nbytes(data))
            b, by = bound_ms(H100, nb, 2 * op.nnz, str(acc).replace("torch.", ""))
            bs, _ = bound_ms(H100, tail + nbytes(data), 2 * op.nnz,
                             str(acc).replace("torch.", ""))
            plan_ = SpMVPlan.compile(op, PlanConfig())
            check(plan_.report.kernel == "cuda", f"{what}: plan runs {plan_.report.kernel}")
            mf_timed[timed] = {
                "ms": time_ms(torch, k), "coded": coded, "streamed_ms": time_ms(torch, ks),
                "streamed_bound_ms": bs, "plain_ms": time_ms(torch, p),
                "library_ms": time_ms(torch, lambda: lib @ xl),
                "plan_ms": time_ms(torch, lambda: plan_(x)), "bound_ms": b, "bound_by": by,
                "bytes": nb, "max_abs_err": err, "rows": nn, "nnz": op.nnz,
                "stored_lanes": op.n_stored, "generated": op.n_generated,
                "shape": f"{what}: {nn} rows, {op.nnz} nnz, {op.n_stored} stored lanes "
                         f"({'coded' if coded else 'streamed'}), {op.n_generated} "
                         "generated diagonals"}
            r = mf_timed[timed]
            log(f"[mf] {what}: kernel {r['ms']:.4f} ms ({'codes' if coded else 'lanes'}; "
                f"lanes streamed {r['streamed_ms']:.4f}, bound {bs:.4f}), plan call "
                f"{r['plan_ms']:.4f}, plain {r['plain_ms']:.4f}, cuSPARSE f64 "
                f"{r['library_ms']:.4f}; bound {b:.4f} ms by {by} ({nb / 1e6:.1f} MB)")
            del lib, plan_

    xl64 = torch.from_numpy(rng.standard_normal(lap.shape[0])).to(dev)
    mf_case(lap, xl64, f"laplacian {args.laplace}^2 f64", timed="laplacian", lib_csr=lap_csr)
    for vd in ("f32", "bf16", "f16"):
        mf_case(F.with_value_dtype(lap, vd), xl64.float(),
                f"laplacian {args.laplace}^2 {vd}, f32 x")
    xe = torch.from_numpy(rng.standard_normal(exact.shape[0])).to(dev)
    mf_case(exact, xe, "holstein exact L=4 f64")
    for vd in ("f32", "bf16", "f16"):
        mf_case(F.with_value_dtype(exact, vd), xe.float(), f"holstein exact L=4 {vd}, f32 x")
    xe6 = torch.from_numpy(rng.standard_normal(ex6.shape[0])).to(dev)
    mf_case(ex6, xe6, f"{ex6_name} f64", timed="exact", lib_csr=ex6_csr)
    ex6_f32 = F.with_value_dtype(ex6, "f32")
    mf_case(ex6_f32, xe6, f"{ex6_name} f32, f64 x", timed="exact_f32_lanes", lib_csr=ex6_csr)
    mf_case(ex6_f32, xe6.float(), f"{ex6_name} f32, f32 x")
    del ex6_f32
    for vd in ("bf16", "f16"):
        ev = F.with_value_dtype(ex6, vd)
        for xv in (xe6.float(), xe6):
            mf_case(ev, xv, f"{ex6_name} {vd}, {str(xv.dtype)[6:]} x")
        del ev
    r = mf_timed["exact"]
    record("mf_spmv", route="cuda", source="src/repro_torch/csrc/mf_spmv.cu",
           replaces="src/repro/kernels/matrix_free.py:262", max_abs_err=r["max_abs_err"],
           ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
           library_ms=r["library_ms"], plan_ms=r["plan_ms"], shapes=mf_timed,
           shape=r["shape"] + ", f64 lanes, f64 x (laplacian and f32 lanes under shapes)")

    # --- 3. the main path: hybrid plan -> Lanczos on the card -----------------
    v0 = np.random.default_rng(1).standard_normal(args.n)
    plan = SpMVPlan.compile(hyb, PlanConfig())
    check(plan.report.kernel == "cuda", f"hybrid plan picked {plan.report.kernel}")
    # the SELL kernel adds into the DIA output: the reference's composition,
    # the two kernels' outputs added, bit for bit
    ctx = R.KernelContext(device=dev)
    fd = R.build(hyb.dia, "dia", "spmv", "cuda", ctx).fn
    fs = R.build(hyb.rest, "sell", "spmv", "cuda", ctx).fn
    check(torch.equal(plan(x64), fd(x64) + fs(x64)),
          "main path: the fused hybrid SpMV is not the DIA output plus the SELL output")
    del fd, fs
    def timed_lanczos(plan_, v0_, reorthogonalize: bool):
        """Lanczos through ``plan_`` from ``v0_``, with CUDA events around
        each SpMV; returns the result, the SpMV times (ms) and the wall time
        (ms)."""
        events = []

        class Timed:
            device = plan_.device

            def __call__(self, x):
                s, e = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                s.record()
                y = plan_(x)
                e.record()
                events.append((s, e))
                return y

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = lanczos(Timed(), v0_.shape[0], m=args.lanczos_steps, v0=v0_,
                    reorthogonalize=reorthogonalize)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return r, [s.elapsed_time(e) for s, e in events], wall

    CB.reset_launch_counts()
    res, spmv_ms, wall_ms = timed_lanczos(plan, v0, True)
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
    _, spmv_ms_plain, wall_ms_plain = timed_lanczos(plan, v0, False)
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
    record("mf_spmv", launches_exact_L4=counts["mf_spmv"])
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

    # --- 4c. the exact operator at the paper's scale through kernel 4 ----------
    plan_x = SpMVPlan.compile(ex6, PlanConfig())
    check(plan_x.report.kernel == "cuda", f"{ex6_name}: plan runs {plan_x.report.kernel}")
    v0x = np.random.default_rng(12).standard_normal(ex6.shape[0])
    CB.reset_launch_counts()
    res_x, spmv_x, wall_x = timed_lanczos(plan_x, v0x, True)
    counts = CB.launch_counts()
    check(counts["mf_spmv"] == res_x.n_spmv and kernel_launches(counts) == res_x.n_spmv,
          f"{ex6_name} path: {counts} launches for {res_x.n_spmv} SpMVs (only mf_spmv, "
          "once each)")
    record("mf_spmv", launches=counts["mf_spmv"],
           launches_per_lanczos_step=counts["mf_spmv"] / res_x.n_spmv)
    ref_x = lanczos(SpMVPlan.compile(ex6, PlanConfig(backend="torch")), ex6.shape[0],
                    m=args.lanczos_steps, v0=v0x)
    dax = float(np.max(np.abs(res_x.alphas - ref_x.alphas)
                       / np.maximum(1e-300, np.abs(ref_x.alphas))))
    dbx = float(np.max(np.abs(res_x.betas - ref_x.betas)
                       / np.maximum(1e-300, np.abs(ref_x.betas))))
    check(res_x.alphas.shape == ref_x.alphas.shape and dax <= 1e-6 and dbx <= 1e-6,
          f"{ex6_name} path: Lanczos through kernel 4 differs from the torch entry "
          f"(alpha {dax:.2e}, beta {dbx:.2e})")
    plan_xc = SpMVPlan.compile(ex6_csr, PlanConfig(format="csr"))
    check(plan_xc.report.kernel == "cuda", f"{ex6_name} csr plan runs {plan_xc.report.kernel}")
    res_xc = lanczos(plan_xc, ex6.shape[0], m=args.lanczos_steps, v0=v0x)
    e0x, e0c = float(res_x.eigenvalues[0]), float(res_xc.eigenvalues[0])
    de0 = abs(e0x - e0c) / max(1e-300, abs(e0c))
    check(de0 <= 1e-8, f"{ex6_name} path: E0 {e0x!r} vs the csr plan's {e0c!r}")
    # the plan call on the card: one mf_spmv kernel a call, no pad copy
    prof_kernels = None
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                plan_x(xe6)
            torch.cuda.synchronize()
        prof_kernels = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                prof_kernels[ev.name] = prof_kernels.get(ev.name, 0) + 1
    except Exception as e:  # the profiler is a diagnostic here; the counts hold
        log(f"[exact6] torch.profiler gave no trace ({type(e).__name__}: {e})")
    if prof_kernels:
        check(len(prof_kernels) == 1 and "mf_spmv_kernel" in next(iter(prof_kernels))
              and next(iter(prof_kernels.values())) == 5,
              f"{ex6_name}: the plan call ran {prof_kernels} on the card, not one "
              "mf_spmv kernel a call")
    t_x = float(np.median(spmv_x))
    out["exact_big"] = {
        "name": ex6_name, "dim": ex6.shape[0], "nnz": ex6_csr.nnz, "steps": res_x.n_spmv,
        "E0": e0x, "E0_csr_plan": e0c, "E0_rel_diff_vs_csr": de0,
        "alpha_rel_diff_vs_torch": dax, "beta_rel_diff_vs_torch": dbx,
        "launches": counts["mf_spmv"], "spmv_ms_median": t_x,
        "spmv_share": float(np.sum(spmv_x)) / wall_x, "lanczos_wall_ms": wall_x,
        "host_build_s": out["exact_big_build_s"], "profiler_kernels": prof_kernels}
    log(f"[exact6] {ex6_name} dim {ex6.shape[0]} -> Lanczos {res_x.n_spmv} steps through "
        f"kernel 4: E0={e0x:.12f} (csr plan {e0c:.12f}, rel diff {de0:.1e}); {t_x:.4f} "
        f"ms/SpMV, SpMV share of Lanczos time {100 * float(np.sum(spmv_x)) / wall_x:.1f} %; "
        f"{counts['mf_spmv']} mf_spmv launches; vs torch entry alpha {dax:.1e}, beta "
        f"{dbx:.1e}; plan call on the card (profiler): {prof_kernels or 'not measured'}")
    del plan_x, plan_xc, ref_x

    # --- 4d. the exact HMeP through the generated kernel mf_product ------------
    out["mf_product"] = mf_product_phase(torch, dev, args, record, compare, ex6, xe6)

    # --- 5. STREAM calibration: kernel 8, then card_chip() --------------------
    gen = torch.Generator(device=dev).manual_seed(5)
    tri = {}
    for dt in (torch.float32, torch.float64):
        a, b, c = (torch.randn(args.triad_n, generator=gen, device=dev, dtype=dt)
                   for _ in range(3))
        k = lambda: GB.stream_triad(a, b, c)  # noqa: E731
        p = lambda: GB.stream_triad_plain(a, b, c)  # noqa: E731
        lib = lambda: torch.addcmul(b, a, c)  # noqa: E731
        name = str(dt).replace("torch.", "")
        err = compare("stream_triad", f"n={args.triad_n} {name} vs plain", k(), p())
        compare("stream_triad", f"n={args.triad_n} {name} vs torch.addcmul", k(), lib())
        check(torch.equal(k(), p()), f"stream_triad {name}: not bitwise the plain version")
        # kernel and library in turns (kernel, library, library, kernel), the
        # better of each pair: the first timing after a pause runs slow
        t_k, t_l = [], []
        for fn_, ts in ((k, t_k), (lib, t_l), (lib, t_l), (k, t_k)):
            ts.append(time_ms(torch, fn_))
        ms = min(t_k)
        tri[name] = {"ms": ms, "plain_ms": time_ms(torch, p), "library_ms": min(t_l),
                     "ms_turns": t_k, "library_ms_turns": t_l,
                     "max_abs_err": err, "bytes": 4 * args.triad_n * a.element_size()}
        if dt == torch.float32:
            bnd, by = bound_ms(H100, tri[name]["bytes"], 2 * args.triad_n, name)
            record("stream_triad", route="cuda", source="src/repro_torch/csrc/gather_bench.cu",
                   replaces="src/repro/kernels/gather_bench.py:37", max_abs_err=err, ms=ms,
                   plain_ms=tri[name]["plain_ms"], bound_ms=bnd, bound_by=by,
                   library_ms=tri[name]["library_ms"],
                   shape=f"o = b + a*c, n = {args.triad_n} f32 (library: torch.addcmul)")
        else:
            record("stream_triad", ms_f64=ms, plain_f64_ms=tri[name]["plain_ms"],
                   library_f64_ms=tri[name]["library_ms"])
        del a, b, c
    CB.reset_launch_counts()
    chip = MB.card_chip(dev, n=args.triad_n)
    counts = CB.launch_counts()
    check(counts["stream_triad"] > 0, "calibration: stream_triad was never launched")
    record("stream_triad", launches=counts["stream_triad"])
    bw64 = MB.stream_triad_bandwidth(args.triad_n, dtype=torch.float64, device=dev)
    share, share64 = chip.hbm_bytes_per_s / H100.hbm_bytes_per_s, bw64 / H100.hbm_bytes_per_s
    for dt, bw in (("f32", chip.hbm_bytes_per_s), ("f64", bw64)):
        check(bw / H100.hbm_bytes_per_s <= 1.05,
              f"calibration: {dt} triad at {bw / 1e12:.3f} TB/s exceeds 1.05 x the data "
              "sheet's 3.35 TB/s: a timing or byte-count fault")
    out["stream"] = {"n": args.triad_n, "bw_f32": chip.hbm_bytes_per_s, "bw_f64": bw64,
                     "share_of_datasheet_f32": share, "share_of_datasheet_f64": share64,
                     "launches": counts["stream_triad"], "per_dtype": tri}
    log(f"[stream] triad n={args.triad_n}: {chip.hbm_bytes_per_s / 1e12:.4f} TB/s f32 "
        f"({100 * share:.1f} % of 3.35), {bw64 / 1e12:.4f} TB/s f64 ({100 * share64:.1f} %); "
        f"kernel {tri['float32']['ms']:.4f} ms vs torch.addcmul "
        f"{tri['float32']['library_ms']:.4f} ms (f32), {tri['float64']['ms']:.4f} vs "
        f"{tri['float64']['library_ms']:.4f} ms (f64); {counts['stream_triad']} launches "
        "in card_chip()")

    # --- 6. microbenchmarks: Table 1 and the gather split (kernel 9) ----------
    nm = args.micro_n
    table1 = MB.run_table1(n=nm, k=8, device=dev)
    for r in table1:
        log(f"[table1] {r.name:10s} {r.ns_per_element:8.4f} ns/elem {r.gbytes_per_s:9.1f} GB/s")
    rng_m = np.random.default_rng(6)
    ind = MB.ind_constant_stride(nm, 8, nm * 8)
    ga = torch.from_numpy(rng_m.standard_normal(nm)).to(dev, torch.float32)
    gx = torch.from_numpy(rng_m.standard_normal(nm * 8)).to(dev, torch.float32)
    gi = torch.from_numpy(ind).to(dev)
    k = lambda: GB.gather_scp(ga, gi, gx)  # noqa: E731
    p = lambda: GB.gather_scp_plain(ga, gi, gx)  # noqa: E731
    err = compare("gather_scp", f"IS k=8 n={nm} f32", k(), p())
    check(torch.equal(k(), p()), "gather_scp: one product per element must be exact")
    ga64, gx64 = ga.double(), gx.double()
    compare("gather_scp", f"IS k=8 n={nm} f64", GB.gather_scp(ga64, gi, gx64),
            GB.gather_scp_plain(ga64, gi, gx64))
    # a, idx read and o written once each, and every touched 32-byte sector
    # of x once: at stride 8 each touched f32 value costs a whole sector (the
    # access-granule penalty the phase measures)
    n_sect = int(np.unique(ind.astype(np.int64) * 4 // 32).size)
    bnd, by = bound_ms(H100, 3 * nm * 4 + n_sect * 32, nm, "float32")
    record("gather_scp", route="cuda", source="src/repro_torch/csrc/gather_bench.cu",
           replaces="src/repro/kernels/gather_bench.py:59", max_abs_err=err,
           ms=time_ms(torch, k), plain_ms=time_ms(torch, p), bound_ms=bnd, bound_by=by,
           library_ms=None, x_sectors=n_sect,
           shape=f"o = a * x[idx], constant stride 8, n = {nm} f32, x {nm * 8} f32 "
                 f"({n_sect} 32-byte sectors touched)")
    CB.reset_launch_counts()
    split = MB.run_gather_split(n=nm, strides=(1, 8), bernoulli_k=8, device=dev)
    counts = CB.launch_counts()
    check(counts["gather_scp"] > 0, "gather split: gather_scp was never launched")
    record("gather_scp", launches=counts["gather_scp"])
    out["micro"] = {"table1": [vars(r) for r in table1], "split": [vars(r) for r in split],
                    "gather_launches": counts["gather_scp"]}
    log("[split] ns/element: " + ", ".join(f"{r.name} {r.ns_per_element:.4f}" for r in split)
        + f"; {counts['gather_scp']} gather_scp launches")

    # --- 7. the model: select_format / format="auto" on card_chip() -----------
    kernel_formats = {f for f in F.FORMATS if R.has(f, "spmv", "cuda")}
    pl = M.power_law_rows(args.powerlaw_n, args.powerlaw_n, mean_nnz=10.0, seed=3,
                          max_nnz=192)
    model_mats = {"surrogate": m, f"laplacian_2d({args.laplace})": lap_csr,
                  f"power_law_rows({args.powerlaw_n})": pl, "holstein_exact L=4": exact_csr}
    # held out: the committed h100 table was fitted on the four matrices
    # above, so these two score it out of sample and never enter the fit
    held_out = {
        f"held-out power_law_rows({args.powerlaw_n}, mean 24, seed 11)": M.power_law_rows(
            args.powerlaw_n, args.powerlaw_n, mean_nnz=24.0, seed=11, max_nnz=192),
        f"held-out surrogate N={args.n // 2} seed 1": M.holstein_hubbard_surrogate(
            args.n // 2, seed=1),
        f"held-out {ex6_name}": ex6_csr}
    model_mats.update(held_out)
    other_chip = dataclasses.replace(chip, name="other_gpu")  # priced off the h100 family

    def score_matrix(mname, mat, held):
        """select_format and a format="auto" plan on card_chip(), then every
        candidate's plan timed: the pick, the measured fastest, per format
        the predicted, model-at-efficiency-1 and measured ms."""
        t0 = time.perf_counter()
        choice = PM.select_format(mat, chip=chip, device=dev)
        plan_a = SpMVPlan.compile(mat, PlanConfig(format="auto", chip=chip))
        rep = plan_a.report
        check(rep.format == choice.format, f"{mname}: auto plan {rep.format} != pick "
                                           f"{choice.format}")
        check(rep.kernel == ("cuda" if rep.format in kernel_formats else "torch"),
              f"{mname}: auto plan of {rep.format} runs {rep.kernel}")
        check(None not in (rep.balance_bytes_per_flop, rep.predicted_gflops,
                           rep.predicted_time_s, rep.bound), f"{mname}: empty report")
        # a kernel that can run is taken whatever chip the plan prices
        rep_o = SpMVPlan.compile(plan_a.matrix, PlanConfig(chip=other_chip)).report
        check(rep_o.kernel == rep.kernel, f"{mname}: a plan priced for another chip "
                                          f"runs {rep_o.kernel}, not {rep.kernel}")
        xm = torch.from_numpy(np.random.default_rng(7).standard_normal(mat.shape[1])).to(dev)
        cand = {}
        for fmt, bal in choice.balances.items():
            obj = _convert_cached(mat, fmt, choice.candidate_kwargs[fmt])
            pa = SpMVPlan.compile(obj, PlanConfig(chip=chip))
            t_eff1 = PM.predict(fmt, bal, max(1, mat.nnz), chip=chip).time_s * 1e3
            row = {"kernel": pa.report.kernel, "predicted_ms": choice.predicted_time_s[fmt] * 1e3,
                   "model_eff1_ms": t_eff1, "measured_ms": time_ms(torch, lambda: pa(xm)),
                   "convert_kwargs": choice.candidate_kwargs[fmt]}
            row["efficiency"] = t_eff1 / row["measured_ms"]
            row["model_error"] = row["predicted_ms"] / row["measured_ms"]
            if pa.report.kernel == "cuda":
                pt = SpMVPlan.compile(obj, PlanConfig(chip=chip, backend="torch"))
                row["torch_ms"] = time_ms(torch, lambda: pt(xm))
                row["torch_efficiency"] = t_eff1 / row["torch_ms"]
            cand[fmt] = row
        fastest = min(cand, key=lambda f: cand[f]["measured_ms"])
        log(f"[model] {mname}: pick {choice.format} ({rep.kernel}), predicted "
            f"{choice.predicted_time_s[choice.format] * 1e3:.4f} ms; measured fastest "
            f"{fastest} ({'pick' if fastest == choice.format else 'not the pick'})")
        for fmt, r in cand.items():
            log(f"[model]   {fmt:11s} {r['kernel']:5s} predicted {r['predicted_ms']:9.4f} "
                f"measured {r['measured_ms']:9.4f} ms, efficiency {r['efficiency']:.3f}"
                + (f"; torch {r['torch_ms']:.4f} ms, efficiency {r['torch_efficiency']:.3f}"
                   if "torch_ms" in r else ""))
        return {"pick": choice.format, "kernel": rep.kernel, "fastest": fastest,
                "pick_is_fastest": fastest == choice.format, "held_out": held,
                "predicted_ms": rep.predicted_time_s * 1e3, "report_bound": rep.bound,
                "candidates": cand, "host_s": time.perf_counter() - t0}

    model, fits = {}, {}
    for mname, mat in model_mats.items():
        model[mname] = score_matrix(mname, mat, mname in held_out)
        # a matrix of a few thousand rows measures launch latency, not the
        # memory rate: only the full-size matrices enter the fit
        if mat.nnz >= 1_000_000 and mname not in held_out:
            for fmt, r in model[mname]["candidates"].items():
                fits.setdefault(fmt, []).append(r["efficiency"])
    geo = lambda v: float(np.exp(np.mean(np.log(v))))  # noqa: E731
    out["model"] = {"chip_bw": chip.hbm_bytes_per_s, "matrices": model,
                    "fitted_h100": {f: geo(v) for f, v in fits.items()}}
    scored = [model[k] for k in held_out]
    log(f"[model] held out: pick = measured fastest on "
        f"{sum(r['pick_is_fastest'] for r in scored)} of {len(scored)}; predicted / "
        f"measured of the pick " + ", ".join(
            f"{r['candidates'][r['pick']]['model_error']:.3f}" for r in scored))
    # the flat composite SELL's overhead per byte over the padded composite's
    s_sig = PM.select_sell_sigma(m.row_lengths(), 8)[0]
    ss = _convert_cached(m, "sell", {"C": 8, "sigma": s_sig})
    cp, cw, col, val, scale, perm = map(on, (ss.chunk_ptr, ss.chunk_width, ss.col_idx,
                                             ss.val, ss.scale, ss.perm))
    seg = on(sell.sell_segment_ids(ss))
    col3, val3 = map(on, sell.sell_padded_views(ss)[:2])
    inv = on(sell.inverse_perm(ss))
    t_flat = time_ms(torch, lambda: sell_spmv.sell_spmv_plain(cp, cw, col, val, scale, perm,
                                                               x64, ss.shape[0], 8, seg))
    t_pad = time_ms(torch, lambda: sell.sell_spmv_padded(col3, val3, inv, x64, ss.shape[0],
                                                         scale))
    vb = ss.val.element_size()
    ovh = (t_flat / (val.numel() * (vb + 8))) / (t_pad / (col3.numel() * (vb + 4)))
    out["model"]["sell_flat_overhead_h100"] = ovh
    del col3, val3
    log(f"[model] fitted h100 efficiencies (geomean over the full-size matrices "
        f"not held out): {json.dumps(out['model']['fitted_h100'])}; flat SELL "
        f"composite {t_flat:.4f} ms vs padded {t_pad:.4f} ms -> overhead {ovh:.3f}")

    # --- 7b. the measured warm path: phase 7's timings as a tuning DB ----------
    t0 = time.perf_counter()
    tdb = TDB.TuneDB()
    for mname, mat in model_mats.items():
        cands = [TDB.Candidate(fmt, r["kernel"], r["measured_ms"] * 1e-3,
                               r["predicted_ms"] * 1e-3, r["model_eff1_ms"] * 1e-3,
                               dict(r["convert_kwargs"]))
                 for fmt, r in model[mname]["candidates"].items()]
        entry = tdb.record(mat, chip=chip, candidates=cands, matrix_name=mname, device=dev)
        check(entry is not None and entry["platform"] == dev.type
              and entry["chip_family"] == "h100", f"{mname}: not recorded under h100/{dev.type}")
    db_path = tdb.save(Path(args.out).parent / "tunedb_h100.json")
    db = TDB.open_db(db_path)
    check(db is not tdb and db.entries.keys() == tdb.entries.keys(),
          f"{db_path}: the reloaded DB does not hold the {len(tdb)} recorded entries")
    record_s = time.perf_counter() - t0
    warm = {}
    for mname, mat in model_mats.items():
        # a new object: the signature of the pattern, not the object, must match
        fresh = F.CSR(mat.row_ptr.clone(), mat.col_idx.clone(), mat.val.clone(), mat.shape)
        t1 = time.perf_counter()
        plan_w = SpMVPlan.compile(fresh, PlanConfig(format="auto", chip=chip, tuning=db))
        t_w = time.perf_counter() - t1
        fastest = model[mname]["fastest"]
        warm[mname] = {"pick": plan_w.report.format, "kernel": plan_w.report.kernel,
                       "fastest": fastest, "compile_s": t_w}
        if plan_w.report.format == fastest:
            check(plan_w.report.kernel == model[mname]["candidates"][fastest]["kernel"],
                  f"{mname}: the warm plan runs {plan_w.report.kernel}")
        log(f"[tunedb] {mname}: warm pick {plan_w.report.format} ({plan_w.report.kernel}), "
            f"measured fastest {fastest}, cold pick {model[mname]['pick']}; compile "
            f"{t_w:.1f} s")
    n_warm = sum(w["pick"] == w["fastest"] for w in warm.values())
    check(n_warm == len(model_mats), f"warm path: the pick is the measured fastest on "
                                     f"{n_warm} of {len(model_mats)}")
    fit_db = PM.fit_efficiency_from_db(db, chip=chip)
    # the cold picks of phase 7 above, made before the DB existed
    cold_fit = [r["pick_is_fastest"] for k, r in model.items() if k not in held_out]
    cold_held = [r["pick_is_fastest"] for k, r in model.items() if k in held_out]
    out["model"]["warm"] = {"db": str(db_path), "entries": len(db), "matrices": warm,
                            "pick_is_fastest": n_warm, "record_s": record_s,
                            "cold_pick_is_fastest": [sum(cold_fit), len(cold_fit)],
                            "cold_pick_is_fastest_held_out": [sum(cold_held), len(cold_held)],
                            "fit_efficiency_from_db": fit_db,
                            "committed_h100": dict(PM.EXEC_EFFICIENCY["h100"])}
    log(f"[tunedb] {len(db)} entries in {db_path.name} (h100 / cuda); warm pick = measured "
        f"fastest on {n_warm} of {len(warm)}; cold picks fastest on "
        f"{sum(cold_fit)} of {len(cold_fit)} and {sum(cold_held)} of {len(cold_held)} held "
        f"out; fit_efficiency_from_db {json.dumps({k: round(v, 4) for k, v in fit_db.items()})}"
        f" vs committed {json.dumps(PM.EXEC_EFFICIENCY['h100'])}")

    # --- 8. batched SpMV through the SELL SpMM kernel ---------------------------
    plan_s = SpMVPlan.compile(ss, PlanConfig(chip=chip))  # sigma from select_sell_sigma
    check(plan_s.report.spmm_kernel == "cuda", f"sell plan SpMM runs {plan_s.report.spmm_kernel}")
    sm = plan_s.matrix
    cp, cw, col, val, scale, perm = map(on, (sm.chunk_ptr, sm.chunk_width, sm.col_idx,
                                             sm.val, sm.scale, sm.perm))
    seg = on(sell.sell_segment_ids(sm))
    sched = sell.sell_chunk_schedule(sm)   # the kernel's chunk order, built once
    storage = sell_spmv.ChunkSchedule(np.arange(sm.n_chunks))   # the order before it
    lib = csr_tensor(torch, *sell_triplets(F, sm), sm.shape, dev)
    bw_choice = PM.select_batch_width(sm, chip=chip, backend="cuda")
    widths = (1, 2, 4, 8, 16, 32, 64)
    Xs = {K: torch.from_numpy(np.random.default_rng(K).standard_normal((args.n, K))).to(dev)
          for K in widths}
    CB.reset_launch_counts()
    Ys = {}
    for K in widths:
        before = CB.launch_counts()["sell_spmm"]
        Ys[K] = plan_s.spmm(Xs[K])
        check(CB.launch_counts()["sell_spmm"] == before + 1,
              f"batched SpMV: sell_spmm not launched once for K={K}")
    counts = CB.launch_counts()
    record("sell_spmm", launches=counts["sell_spmm"])
    batch = {}
    for K in widths:
        errs = [compare("sell_spmm", f"surrogate sigma={s_sig} K={K} cols {j}:{j + 16}",
                        Ys[K][:, j:j + 16], sell_spmv.sell_spmm_plain(
                            cp, cw, col, val, scale, perm, Xs[K][:, j:j + 16].contiguous(),
                            args.n, sm.C, seg)) for j in range(0, K, 16)]
        X = Xs[K]
        k = lambda: sell_spmv.sell_spmm_arrays(cp, cw, col, val, scale, perm, X,  # noqa: E731
                                               args.n, sm.C, sched)
        check(torch.equal(k(), Ys[K]), f"batched SpMV K={K}: two calls differ in their bits")
        t = time_ms(torch, k)
        b_ms, b_by = bound_ms(H100, nbytes(cp, cw, col, val, scale, perm)
                              + 2 * X.numel() * 8, 2 * sm.nnz * K, "float64")
        # every stored slot gathers K values of X (from L2 where the window fits)
        gather = col.numel() * K * X.element_size()
        row = {"ms": t, "library_ms": time_ms(torch, lambda: lib @ X), "bound_ms": b_ms,
               "bound_by": b_by, "max_abs_err": max(errs),
               "plain_ms": time_ms(torch, lambda: sell_spmv.sell_spmm_plain(
                   cp, cw, col, val, scale, perm, X, args.n, sm.C, seg), reps=5),
               "storage_order_ms": time_ms(torch, lambda: sell_spmv.sell_spmm_arrays(
                   cp, cw, col, val, scale, perm, X, args.n, sm.C, storage)),
               "gather_bytes": gather, "gather_tb_s": gather / (t * 1e-3) / 1e12,
               "launch_ct_tpr": sell_spmv.sell_spmm_launch(K, 8),
               "measured_qps": K / (t * 1e-3),
               "predicted_qps": bw_choice.throughput.get(K)}
        if K == 16:
            record("sell_spmm", route="cuda", source="src/repro_torch/csrc/sell_spmm.cu",
                   replaces="src/repro/kernels/sell_spmv.py:147", max_abs_err=row["max_abs_err"],
                   ms=t, plain_ms=row["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                   library_ms=row["library_ms"],
                   shape=f"surrogate SELL C=8 sigma={s_sig}, {sm.nnz} nnz, val f32, "
                         "X (N, 16) f64")
        batch[K] = row
        log(f"[spmm] K={K:2d}: {t:.4f} ms ({row['measured_qps']:.0f} SpMV/s; model "
            f"{row['predicted_qps']:.0f}; chunks in storage order "
            f"{row['storage_order_ms']:.4f} ms), plain {row['plain_ms']:.4f}, cuSPARSE "
            f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}; X gathers "
            f"{gather / 1e9:.3f} GB at {row['gather_tb_s']:.3f} TB/s; (ct, tpr) "
            f"{row['launch_ct_tpr']}; max abs err {row['max_abs_err']:.2e}")
    # every value dtype the kernel takes, at K = 16: f64 X (f64 accumulation)
    # and f32 X (f32 accumulation, f64 for f64 values)
    for vd in VALUE_DTYPES:
        sv = F.with_value_dtype(sm, vd)
        ops = list(map(on, (sv.chunk_ptr, sv.chunk_width, sv.col_idx, sv.val, sv.scale,
                            sv.perm)))
        for X in (Xs[16], Xs[16].float()):
            compare("sell_spmm", f"surrogate {vd} values, X {str(X.dtype)[6:]} K=16",
                    sell_spmv.sell_spmm_arrays(*ops, X, args.n, sv.C, sched),
                    sell_spmv.sell_spmm_plain(*ops, X, args.n, sv.C, seg))
        del ops
    del Ys, Xs
    out["batched"] = {"sigma": s_sig, "launches": counts["sell_spmm"], "per_k": batch,
                      "select_batch_width": bw_choice.width,
                      "predicted_throughput": bw_choice.throughput}
    slower = [K for K in widths if batch[K]["ms"] > batch[K]["library_ms"]]
    log(f"[spmm] select_batch_width picks K={bw_choice.width} (saturation "
        f"{bw_choice.saturation:.3f}); {counts['sell_spmm']} sell_spmm launches for "
        f"{len(widths)} plan.spmm calls; kernel 5 slower than cuSPARSE at K in "
        f"{slower or 'none'}")

    # --- 9. sparse weights: SparseLinear (kernel 6), grouped GEMM (kernel 7) ----
    # f32 products in full f32 on both sides (cuBLAS would otherwise be free
    # to take TF32 if the process enabled it)
    torch.backends.cuda.matmul.allow_tf32 = False

    def bytes_bound(nbytes_, flops_, peak_flops):
        """(bound ms at 3.35 TB/s, bound ms at the measured triad rate, by)."""
        t_ops = flops_ / peak_flops * 1e3
        t_b, t_bm = nbytes_ / H100.hbm_bytes_per_s * 1e3, nbytes_ / chip.hbm_bytes_per_s * 1e3
        return (max(t_b, t_ops), max(t_bm, t_ops), "bytes" if t_b >= t_ops else "operations")

    # 9a. SparseLinear at Gemma-7B FFN width: the gate projection (d_ff, d_model)
    t0 = time.perf_counter()
    d_ff, d_model = args.gemma_ff, args.gemma_model
    w0 = np.random.default_rng(9).standard_normal((d_ff, d_model), dtype=np.float32)
    w = magnitude_prune(w0, 0.25, structured=(8, 128))
    advised = advise_weight_format(w, (8, 128))
    check(advised == "bsr", f"advisor picked {advised} for a (8, 128)-block-pruned weight")
    lin = SparseLinear.from_dense(w, fmt="auto", device=dev)
    check(lin.fmt == "bsr", f"SparseLinear.from_dense(fmt='auto') stored {lin.fmt}")
    hb = F.BSR.from_dense(w, (8, 128))                 # the same arrays, on the host
    nb = hb.n_blocks
    fill = bell_fill_ratio(hb)
    W_dev = torch.from_numpy(w).to(dev)
    batches = (1, 8, 64)
    xs = {B: torch.from_numpy(np.random.default_rng(100 + B).standard_normal(
        (B, d_model), dtype=np.float32)).to(dev) for B in batches}
    CB.reset_launch_counts()
    ys = {}
    for B in batches:
        path = f"bell_spmm_{bell_launch(8, 128, B, 4).path}"
        before = CB.launch_counts()
        ys[B] = lin(xs[B])
        after = CB.launch_counts()
        check(after["bell_spmm"] == before["bell_spmm"] + 1
              and after[path] == before[path] + 1,
              f"SparseLinear B={B}: bell_spmm not launched once on its path {path}")
    counts = CB.launch_counts()
    check(counts["bell_spmm_decode"] == 1 and counts["bell_spmm_wide"] == 2,
          f"SparseLinear: per-path launches {counts['bell_spmm_decode']} decode, "
          f"{counts['bell_spmm_wide']} wide (expected 1 and 2)")
    record("bell_spmm", launches=counts["bell_spmm"])
    for B in batches:
        compare("bell_spmm", f"SparseLinear B={B} vs dense x @ W.T", ys[B], xs[B] @ W_dev.T)
    host_9a = time.perf_counter() - t0
    log(f"[sparse] gemma-7b gate W ({d_ff}, {d_model}) pruned to 25 % in (8, 128) blocks: "
        f"advised {advised}; {nb} blocks, {nb * 8 * 128 * 4 / 1e6:.1f} MB f32; BELL fill "
        f"ratio {fill:.3f}; bell_spmm launches {counts['bell_spmm']} (decode "
        f"{counts['bell_spmm_decode']}, wide {counts['bell_spmm_wide']}) for "
        f"{len(batches)} layer calls; host {host_9a:.1f} s")
    # the kernel against its plain version for every value dtype, B = 8, f32 x
    M_ = d_ff
    X8 = xs[8].T.contiguous()
    dense64 = (xs[8].double() @ W_dev.double().T).T
    sweep = {}
    for vd in VALUE_DTYPES:
        mv = F.with_value_dtype(hb, vd)
        bc, sl = map(on, bsr_to_bell(mv))
        sc, ln = on(bell_scale(mv)), on(bell_row_nblocks(mv))
        got = bell_spmm_arrays(bc, sl, X8, sc, ln, M_)
        err = compare("bell_spmm", f"gemma W {vd} blocks, B=8 f32 x", got,
                      bell_spmm_plain(bc, sl, X8, sc, M_))
        budget = TOL["float64"] if vd == "f64" else VALUE_DTYPE_TOL[vd]
        _, rel64 = rel_err(torch, got, dense64)
        check(rel64 <= budget, f"bell_spmm {vd}: {rel64:.3e} from the f64 dense product "
                               f"(budget {budget:g})")
        sweep[vd] = {"max_abs_err_vs_plain": err, "rel_err_vs_f64_dense": rel64}
        log(f"[sparse]   {vd:8s} blocks: rel err vs f64 dense {rel64:.3e} (budget {budget:g})")
        del bc, sl, sc, ln, mv
    # times at each decode batch: kernel, plain, dense cuBLAS, library, bound
    bc, sl = map(on, bsr_to_bell(hb))
    ln = on(bell_row_nblocks(hb))
    brp_d, bci_d, blk_d = on(hb.block_row_ptr), on(hb.block_col_idx), on(hb.blocks)
    try:   # torch's block-sparse product, where this build runs it on the card
        lib_t = torch.sparse_bsr_tensor(brp_d.long(), bci_d.long(), blk_d, size=(d_ff, d_model))
        (lib_t @ X8).sum().item()
        lib_kind = "torch.sparse_bsr_tensor @ X"
    except (RuntimeError, NotImplementedError) as e:
        log(f"[sparse] torch.sparse_bsr_tensor @ X does not run on the card ({e}); the "
            "library yardstick is torch.sparse_csr_tensor of the same matrix")
        lib_t = W_dev.to_sparse_csr()
        lib_kind = "torch.sparse_csr_tensor @ X"
    per_b = {}
    for B in batches:
        X = xs[B].T.contiguous()
        k = lambda: bell_spmm_arrays(bc, sl, X, None, ln, M_)  # noqa: E731
        p = lambda: bell_spmm_plain(bc, sl, X, None, M_)  # noqa: E731
        xb = xs[B]
        got_b = k()
        err_b = compare("bell_spmm", f"gemma W f32 blocks, B={B} vs plain", got_b, p())
        check(torch.equal(got_b, k()), f"bell_spmm B={B}: two calls differ in their bits")
        nby = nb * 8 * 128 * 4 + nb * 4 + X.numel() * 4 + M_ * B * 4
        b_ms, b_ms_m, b_by = bytes_bound(nby, 2 * nb * 8 * 128 * B, H100.peak_flops_fp32)
        row = {"ms": time_ms(torch, k), "plain_ms": time_ms(torch, p, reps=5),
               "dense_ms": time_ms(torch, lambda: xb @ W_dev.T),
               "library_ms": time_ms(torch, lambda: lib_t @ X), "library": lib_kind,
               "bound_ms": b_ms, "bound_ms_at_measured_bw": b_ms_m, "bound_by": b_by,
               "bytes": nby, "launch": bell_launch(8, 128, B, 4)._asdict()}
        per_b[B] = row
        L = row["launch"]
        log(f"[sparse] B={B:2d}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
            f"dense x @ W.T {row['dense_ms']:.4f}, {lib_kind} {row['library_ms']:.4f}, bound "
            f"{b_ms:.4f} ({b_ms_m:.4f} at the triad rate) by {b_by}; "
            f"{2 * nb * 8 * 128 * B / (row['ms'] * 1e-3) / 1e12:.2f} TFLOP/s; launch rm "
            f"{L['rm']} cw {L['cw']} ntile {L['ntile']} G {L['G']} stages {L['stages']} "
            f"({L['smem']} B)")
        if B == 1:
            record("bell_spmm", route="cuda", source="src/repro_torch/csrc/bell_spmm.cu",
                   replaces="src/repro/kernels/bsr_spmm.py:65",
                   max_abs_err=err_b, ms=row["ms"], plain_ms=row["plain_ms"],
                   bound_ms=b_ms, bound_by=b_by, library_ms=row["library_ms"],
                   shape=f"gemma-7b gate ({d_ff}, {d_model}), {nb} (8, 128) f32 blocks, "
                         f"B = 1 f32 (library: {lib_kind})")
    del lib_t, bc, sl, ln, brp_d, bci_d, blk_d
    # the unstructured alternative: SELL through kernel 5
    ws = magnitude_prune(w0, 0.1)
    lin_s = SparseLinear.from_dense(ws, fmt="sell", device=dev)
    Ws_dev = torch.from_numpy(ws).to(dev)
    before = CB.launch_counts()["sell_spmm"]
    ysl = lin_s(xs[8])
    check(CB.launch_counts()["sell_spmm"] == before + 1, "SparseLinear(sell): sell_spmm "
                                                         "not launched once")
    compare("sell_spmm", "SparseLinear sell density 0.1, B=8 vs dense", ysl, xs[8] @ Ws_dev.T)
    sell_ms = time_ms(torch, lambda: lin_s(xs[8]))
    log(f"[sparse] unstructured density 0.1 as SELL ({lin_s.matrix.nnz} nnz): layer B=8 "
        f"{sell_ms:.4f} ms through sell_spmm")
    out["sparse_linear"] = {"shape": [d_ff, d_model], "advised": advised, "n_blocks": nb,
                            "bell_fill_ratio": fill, "launches": counts["bell_spmm"],
                            "per_batch": per_b, "value_dtypes": sweep,
                            "sell_density_0.1_B8_ms": sell_ms, "host_s": host_9a}
    del lin, lin_s, W_dev, Ws_dev, w0, w, ws, dense64

    # 9b. ops.grouped_gemm at DeepSeek-V2-Lite expert width
    E, Dm, Fe, topk, bt = args.moe_experts, args.moe_d, args.moe_f, 6, 128
    rng_g = np.random.default_rng(12)
    X_tok = rng_g.standard_normal((args.moe_tokens, Dm), dtype=np.float32)
    T = args.moe_tokens * topk
    eot = rng_g.integers(0, E, T)
    Xd = torch.from_numpy(np.repeat(X_tok, topk, axis=0)).to(dev)
    Wd = expert_weights(rng_g.standard_normal((E, Dm, Fe), dtype=np.float32), dev)
    order, inv, te, T_pad = plan_groups(eot, E, bt)
    counts_e = np.bincount(eot, minlength=E)
    te_d, inv_d = on(torch.from_numpy(te)), on(torch.from_numpy(inv.astype(np.int64)))
    sample = np.random.default_rng(13).choice(T, 256, replace=False)
    moe = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        Xg, Wg = Xd.to(dt), Wd.to(dt)
        # f32 runs the SIMT kernel, bf16 the wgmma kernel (gemm_plan's rule)
        path = gemm_plan(bt, Dm, Fe, dt, dt)[0]
        check(path == ("simt" if dt == torch.float32 else "wgmma"),
              f"grouped_gemm {name}: gemm_plan picks {path}")
        CB.reset_launch_counts()
        Y = KOPS.grouped_gemm(Xg, eot, Wg, bt=bt)
        counts_g = CB.launch_counts()
        want_counts = {"grouped_gemm": 1, "grouped_gemm_simt": int(path == "simt"),
                       "grouped_gemm_wgmma": int(path == "wgmma")}
        check(all(counts_g[k_] == v for k_, v in want_counts.items()),
              f"grouped_gemm {name}: ops.grouped_gemm launched "
              f"{ {k_: counts_g[k_] for k_ in want_counts} }, expected {want_counts}")
        launches_g = counts_g[f"grouped_gemm_{path}"]
        Xp = torch.zeros((T_pad, Dm), dtype=dt, device=dev).index_copy_(0, inv_d, Xg)
        k = lambda: grouped_gemm_arrays(te_d, Xp, Wg, bt=bt)  # noqa: E731
        p = lambda: grouped_gemm_plain(te_d, Xp, Wg, bt)  # noqa: E731
        if dt == torch.float32:
            err = compare("grouped_gemm", f"E={E} D={Dm} F={Fe} T_pad={T_pad} f32", k(), p())
        else:
            err, rel = rel_err(torch, k(), p())
            ok = rel <= 1e-2
            checks.append({"kernel": "grouped_gemm", "case": "bf16 vs plain", "acc": name,
                           "max_abs_err": err, "rel_err": rel, "ok": ok})
            log(f"[check] grouped_gemm bf16 vs plain rel err {rel:.3e}")
            check(ok, f"grouped_gemm bf16: rel err {rel:.3e} > 1e-2 of max|plain|")
        # the unsorted result against a per-token product on 256 routed rows
        want = torch.empty((256, Fe), dtype=torch.float64, device=dev)
        for e in np.unique(eot[sample]):
            sel = np.nonzero(eot[sample] == e)[0]
            want[sel] = Xg[sample[sel]].double() @ Wg[int(e)].double()
        _, rel_tok = rel_err(torch, Y[sample], want)
        tok_tol = TOL["float32"] if dt == torch.float32 else 1e-2
        check(rel_tok <= tok_tol, f"grouped_gemm {name}: per-token rel err {rel_tok:.3e}")
        # library: one torch.matmul per expert group (64 calls); bf16 also
        # torch._grouped_mm where this build has it
        Xs = Xg[torch.from_numpy(order.astype(np.int64)).to(dev)]
        starts = np.concatenate([[0], np.cumsum(counts_e)])
        groups = [(int(starts[e]), int(starts[e + 1]), e) for e in range(E)
                  if counts_e[e]]
        lib = lambda: [torch.matmul(Xs[a:b], Wg[e]) for a, b, e in groups]  # noqa: E731
        row = {"ms": time_ms(torch, k), "plain_ms": time_ms(torch, p, reps=5),
               "library_ms": time_ms(torch, lib), "library": "torch.matmul per expert group",
               "T": T, "T_pad": T_pad, "path": path, "launches": launches_g,
               "per_token_rel_err": rel_tok, "max_abs_err": err}
        if dt == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
            offs = torch.from_numpy(np.cumsum(counts_e).astype(np.int32)).to(dev)
            try:
                row["grouped_mm_ms"] = time_ms(torch, lambda: torch._grouped_mm(Xs, Wg,
                                                                                offs=offs))
            except (RuntimeError, TypeError) as e:
                row["grouped_mm_error"] = str(e)[:200]
        es = Xg.element_size()
        nby = (T_pad * Dm + E * Dm * Fe + T_pad * Fe) * es
        peak = H100.peak_flops_fp32 if dt == torch.float32 else 989e12
        row["bound_ms"], row["bound_ms_at_measured_bw"], row["bound_by"] = bytes_bound(
            nby, 2 * T_pad * Dm * Fe, peak)
        moe[name] = row
        log(f"[moe] {name}: T={T} routed rows -> T_pad={T_pad}; {path} kernel "
            f"{row['ms']:.4f} ms ({2 * T_pad * Dm * Fe / row['ms'] / 1e9:.1f} TFLOP/s at "
            f"T_pad), "
            f"plain {row['plain_ms']:.4f}, per-group torch.matmul {row['library_ms']:.4f}"
            + (f", torch._grouped_mm {row['grouped_mm_ms']:.4f}" if "grouped_mm_ms" in row
               else "") + f"; bound {row['bound_ms']:.4f} by {row['bound_by']}; per-token "
            f"rel err {rel_tok:.1e}; launches {launches_g}")
        if dt == torch.float32:
            record("grouped_gemm", route="cuda", source="src/repro_torch/csrc/grouped_gemm.cu",
                   replaces="src/repro/kernels/moe_gemm.py:59", max_abs_err=err,
                   ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                   bound_by=row["bound_by"], library_ms=row["library_ms"],
                   launches=launches_g,
                   shape=f"deepseek-v2-lite experts E={E} D={Dm} F={Fe}, T_pad={T_pad} f32, "
                         "SIMT kernel (library: torch.matmul per expert group, 64 calls)")
        else:
            lib_name = "torch._grouped_mm" if "grouped_mm_ms" in row else \
                "torch.matmul per expert group"
            record("grouped_gemm_wgmma", route="cuda",
                   source="src/repro_torch/csrc/grouped_gemm.cu",
                   replaces="src/repro/kernels/moe_gemm.py:59", max_abs_err=err,
                   ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                   bound_by=row["bound_by"],
                   library_ms=row.get("grouped_mm_ms", row["library_ms"]),
                   launches=launches_g,
                   shape=f"deepseek-v2-lite experts E={E} D={Dm} F={Fe}, T_pad={T_pad} bf16, "
                         f"wgmma + TMA kernel (library: {lib_name} over the T={T} routed "
                         "rows, 25 % fewer than T_pad)")
        del Xg, Wg, Xp, Xs, Y
    out["moe"] = moe
    del Xd, Wd

    # 9c. the plan path for BSR: PlanConfig(format="bsr"), format="auto"
    t0 = time.perf_counter()
    nbs = args.bsr_n
    bs = F.CSR.from_dense(M.block_sparse_dense(nbs, nbs, (8, 128), 0.25, seed=4))
    xb = torch.from_numpy(np.random.default_rng(7).standard_normal(nbs)).to(dev)
    plan_b = SpMVPlan.compile(bs, PlanConfig(format="bsr", chip=chip))
    check(plan_b.report.kernel == "cuda", f"bsr plan runs {plan_b.report.kernel}")
    CB.reset_launch_counts()
    yb = plan_b(xb)
    check(CB.launch_counts()["bell_spmm"] == 1 and CB.launch_counts()["bell_spmm_decode"] == 1,
          "bsr plan: bell_spmm not launched once on its decode path")
    compare("bell_spmm", f"bsr plan {nbs}^2 vs torch plan, f64 x", yb,
            SpMVPlan.compile(plan_b.matrix, PlanConfig(chip=chip, backend="torch"))(xb))
    plan_o = SpMVPlan.compile(plan_b.matrix, PlanConfig(chip=other_chip))
    plan_o(xb)
    check(plan_o.report.kernel == "cuda" and CB.launch_counts()["bell_spmm"] == 2,
          "a bsr plan priced for another chip does not run bell_spmm")
    bsr_model = {}
    for mname, mat, held in (
            (f"block_sparse_dense({nbs}, 0.25, seed 4)", bs, False),
            (f"held-out block_sparse_dense({nbs}, 0.35, seed 11)", F.CSR.from_dense(
                M.block_sparse_dense(nbs, nbs, (8, 128), 0.35, seed=11)), True)):
        res = score_matrix(mname, mat, held)
        check("bsr" in res["candidates"], f"{mname}: select_format did not price bsr")
        if res["pick"] == "bsr":
            plan_a = SpMVPlan.compile(mat, PlanConfig(format="auto", chip=chip))
            before = CB.launch_counts()["bell_spmm"]
            plan_a(torch.from_numpy(np.random.default_rng(8).standard_normal(nbs)).to(dev))
            check(plan_a.report.kernel == "cuda"
                  and CB.launch_counts()["bell_spmm"] == before + 1,
                  f"{mname}: the auto plan picked bsr but did not run bell_spmm")
        bsr_model[mname] = res
    fit_m = next(r for r in bsr_model.values() if not r["held_out"])
    held_m = next(r for r in bsr_model.values() if r["held_out"])
    out["bsr_plans"] = {"matrices": bsr_model, "nnz": bs.nnz,
                        "fitted_h100_bsr": fit_m["candidates"]["bsr"]["efficiency"],
                        "host_s": time.perf_counter() - t0}
    log(f"[bsr] {nbs}^2 ({bs.nnz} nnz): bsr plan runs {plan_b.report.kernel}, launches "
        f"counted; auto picks {fit_m['pick']} (fastest {fit_m['fastest']}); fitted h100 bsr "
        f"efficiency {out['bsr_plans']['fitted_h100_bsr']:.3f}; held out: picks "
        f"{held_m['pick']}, fastest {held_m['fastest']}, predicted / measured of the pick "
        f"{held_m['candidates'][held_m['pick']]['model_error']:.3f}")
    del bs, plan_b, plan_o
    # kernel 3 on every matrix it ran at full size: the surrogate (phase 2c),
    # the csr plans of phases 7 and 9c
    csr_ms = {mname: r["candidates"]["csr"]["measured_ms"]
              for mname, r in list(model.items()) + list(bsr_model.items())
              if "csr" in r["candidates"]}
    out["csr_plans_ms"] = csr_ms
    kr3 = rows["csr_spmv"]
    log(f"[csr] kernel 3 on the surrogate {kr3['ms']:.4f} ms (cuSPARSE f64 values "
        f"{kr3['library_ms']:.4f}, f32 values + f32 x {kr3['library_f32_ms']:.4f}; bound "
        f"{kr3['bound_ms']:.4f}); csr plans: " + "; ".join(
            f"{k_} {v:.4f} ms" for k_, v in csr_ms.items()))

    # --- 10. the corpus on the card -------------------------------------------
    t0 = time.perf_counter()
    CB.reset_launch_counts()
    corpus_out, rob_plan = {}, None
    for name in CORPUS.names():
        spec = CORPUS.get(name)
        cm = CORPUS.build(name)
        ch = cm.to_coo()
        rows_h, cols_h = ch.rows.long(), ch.cols.long()
        vals_h = ch.vals.double()
        rng_c = np.random.default_rng(20)
        xh = torch.from_numpy(rng_c.standard_normal(cm.shape[1]))
        Xh = torch.from_numpy(rng_c.standard_normal((cm.shape[1], 4)))

        def host_product(Vh):
            """The f64 product of the stored values on the host."""
            prod = (vals_h if Vh.dim() == 1 else vals_h[:, None]) * Vh.double()[cols_h]
            return torch.zeros((cm.shape[0],) + tuple(Vh.shape[1:]),
                               dtype=torch.float64).index_add_(0, rows_h, prod)

        fmts = list(spec.formats) + ["coo"] + (["matrix_free"] if spec.matrix_free else [])
        per_fmt = {}
        for fmt in fmts:
            if fmt == "matrix_free":
                plan_c = SpMVPlan.compile(CORPUS.matrix_free_operator(name), PlanConfig())
            else:
                plan_c = SpMVPlan.compile(cm, PlanConfig(format=fmt))
            check(plan_c.report.format == fmt, f"{name}: {fmt} plan is {plan_c.report.format}")
            worst = 0.0
            for xd in (torch.float64, torch.float32):
                xv, Xv = xh.to(xd), Xh.to(xd)
                y, Y = plan_c(xv.to(dev)), plan_c.spmm(Xv.to(dev))
                for got, want in ((y, host_product(xv)), (Y, host_product(Xv))):
                    _, rel = rel_err(torch, got.cpu(), want)
                    tol = TOL[str(got.dtype).replace("torch.", "")]
                    check(tuple(got.shape) == tuple(want.shape)
                          and bool(torch.isfinite(got).all()) and rel <= tol,
                          f"corpus {name} {fmt} ({plan_c.report.kernel}, x {xd}): rel err "
                          f"{rel:.3e} > {tol:g} against the host f64 product")
                    worst = max(worst, rel / tol)
            per_fmt[fmt] = {"kernel": plan_c.report.kernel, "spmm_kernel":
                            plan_c.report.spmm_kernel, "worst_err_over_tol": worst}
            if name == "holstein_surrogate" and fmt == "sell":
                rob_plan = plan_c
        pick = SpMVPlan.compile(cm, PlanConfig(format="auto")).report.format
        corpus_out[name] = {"shape": list(cm.shape), "nnz": cm.nnz, "auto_pick": pick,
                            "plans": per_fmt}
        log(f"[corpus] {name:18s} {cm.shape[0]:5d} rows {cm.nnz:6d} nnz: " + ", ".join(
            f"{f} {r['kernel']}/{r['spmm_kernel']}" for f, r in per_fmt.items())
            + f"; auto picks {pick}")
    # the robustness path on the card, on one plan (SELL kernels 1 and 5)
    n_r = rob_plan.report.shape[0]
    rng_r = np.random.default_rng(21)
    xr = torch.from_numpy(rng_r.standard_normal(n_r)).to(dev)
    Xr = torch.from_numpy(rng_r.standard_normal((n_r, 4))).to(dev)
    y0, Y0 = rob_plan(xr), rob_plan.spmm(Xr)
    with faults.inject("plan.spmv", nonfinite=True) as spec_f:
        yb = rob_plan(xr)
    check(spec_f.fired == 1 and yb.device == y0.device and bool(torch.isnan(yb[0]))
          and int(torch.isnan(yb).sum()) == 1, "faults: plan.spmv did not poison plan(x)")
    try:
        V.validate_vector(yb, n_r)
        refused = False
    except V.VectorValidationError:
        refused = True
    check(refused, "validate_vector passed a poisoned vector")
    with faults.inject("plan.spmm", nonfinite=True, column=2):
        Yb = rob_plan.spmm(Xr)
    flags = V.check_finite_columns(Yb)
    check(flags.device == Yb.device and flags.tolist() == [True, True, False, True],
          f"check_finite_columns flagged {flags.tolist()}, not column 2")
    with faults.inject("plan.spmv", nonfinite=True, times=None):
        try:
            lanczos(rob_plan, n_r, m=16, v0=rng_r.standard_normal(n_r))
            broke = False
        except LanczosBreakdown:
            broke = True
    check(broke, "lanczos on a poisoned plan did not raise LanczosBreakdown")
    faults.reset()
    check(torch.equal(rob_plan(xr), y0) and torch.equal(rob_plan.spmm(Xr), Y0),
          "after faults.reset() the plan does not return its earlier bits")
    counts = CB.launch_counts()
    path_kernels = ("sell_spmv", "dia_spmv", "csr_spmv", "mf_spmv", "sell_spmm", "bell_spmm")
    for name in path_kernels:
        check(counts[name] > 0, f"corpus phase: {name} was never launched")
        record(name, launches_corpus=counts[name])
    out["corpus"] = {"specs": corpus_out, "launches": {k: counts[k] for k in path_kernels},
                     "robustness": {"plan": "holstein_surrogate sell",
                                    "poisoned_column": 2, "lanczos_breakdown": broke},
                     "host_s": time.perf_counter() - t0}
    n_plans = sum(len(c["plans"]) for c in corpus_out.values())
    log(f"[corpus] {len(corpus_out)} specs, {n_plans} plans within tolerance of the host f64 "
        f"product (f64 and f32 x, SpMV and SpMM K = 4); launches " + ", ".join(
            f"{k} {counts[k]}" for k in path_kernels) + "; faults: plan(x) poisoned, column 2 "
        f"flagged, LanczosBreakdown raised, bits restored after reset; "
        f"{out['corpus']['host_s']:.1f} s")

    # --- 11. MatrixMarket at the paper's scale ---------------------------------
    stem = f"holstein_surrogate_{args.n}"
    secs = {}
    t0 = time.perf_counter()
    mtx_path = IO.write_mtx(REPO / "build" / "corpus" / f"{stem}.mtx", m)
    secs["write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = IO.load_matrix(stem, search_dirs=[REPO / "build" / "corpus"], validate="strict")
    secs["read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(V.validate_matrix(loaded, "strict") is loaded, f"{stem}: not valid")
    secs["validate"] = time.perf_counter() - t0
    check(loaded._source == str(mtx_path) and loaded.shape == m.shape and all(
        getattr(loaded, f).dtype == getattr(m, f).dtype
        and torch.equal(getattr(loaded, f), getattr(m, f))
        for f in ("row_ptr", "col_idx", "val")),
        f"{stem}: the CSR read back is not bitwise the one in memory")
    t0 = time.perf_counter()
    plan_l = SpMVPlan.compile(loaded, PlanConfig(format="auto"))
    secs["compile"] = time.perf_counter() - t0
    plan_m = SpMVPlan.compile(m, PlanConfig(format="auto"))
    check((plan_l.report.format, plan_l.report.kernel) == (plan_m.report.format,
                                                           plan_m.report.kernel),
          f"{stem}: the file's plan is {plan_l.report.format}, the in-memory one "
          f"{plan_m.report.format}")
    res_l = lanczos(plan_l, args.n, m=args.lanczos_steps, v0=v0)
    res_m = lanczos(plan_m, args.n, m=args.lanczos_steps, v0=v0)
    e_l, e_m = float(res_l.eigenvalues[0]), float(res_m.eigenvalues[0])
    check(e_l == e_m, f"{stem}: E0 {e_l!r} from the file, {e_m!r} in memory")
    size = mtx_path.stat().st_size
    mtx_path.unlink()
    out["mtx"] = {"n": args.n, "nnz": m.nnz, "bytes": size, "host_s": secs,
                  "round_trip_s": sum(secs.values()), "format": plan_l.report.format,
                  "kernel": plan_l.report.kernel, "steps": res_l.n_spmv, "E0": e_l}
    log(f"[mtx] {stem}: {m.nnz} entries, {size / 1e6:.1f} MB; host s: write "
        f"{secs['write']:.1f}, read (load_matrix, strict) {secs['read']:.1f}, "
        f"validate_matrix strict {secs['validate']:.1f}, compile (auto -> "
        f"{plan_l.report.format}) {secs['compile']:.1f}; total {sum(secs.values()):.1f} s; "
        f"CSR bitwise; {res_l.n_spmv} Lanczos steps, E0 {e_l:.12f} = in-memory plan's")
    del loaded, plan_l, plan_m

    # --- 12. serving: BatchingSpMVServer at the paper's scale --------------------
    t12 = time.perf_counter()
    f64 = torch.float64

    class FakeClock:
        """A clock the script steps by hand (deadlines without sleeping)."""

        def __init__(self):
            self.t = 0.0

        def advance(self, dt):
            self.t += dt

        def __call__(self):
            return self.t

    def serve_round(srv_, name, xs_):
        """Submit ``xs_`` in order and read every result: (results, wall s)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys_ = [f.result() for f in srv_.submit_many(name, xs_)]
        torch.cuda.synchronize()
        return ys_, time.perf_counter() - t0

    def worst_rel(got, want):
        return max(rel_err(torch, g, w)[1] for g, w in zip(got, want))

    # 12a. the surrogate through kernel 5: phase 8's SELL container, priced on
    # the measured card, the width from select_batch_width
    card = MB.card_chip(dev, n=args.triad_n)   # memoized: phase 5's calibration
    srv = SERVE.BatchingSpMVServer(chip=card, max_batch=None, deadline_s=10.0)
    rep = srv.register("surrogate", ss)
    check(rep.kernel == rep.spmm_kernel == "cuda" and srv.plan("surrogate") is plan_s,
          f"serving: the surrogate's plan runs {rep.kernel} / {rep.spmm_kernel}, or is not "
          "phase 8's plan")
    width = srv.stats()["surrogate"]["batch_width"]
    check(width == PM.select_batch_width(ss, chip=card, backend="cuda").width and width > 1,
          f"serving: width {width} is not select_batch_width's")
    R = 8 * width
    gen_s = torch.Generator(device=dev).manual_seed(12)
    xs_all = list(torch.randn((R + width - 1, args.n), generator=gen_s, device=dev, dtype=f64))
    xs, xs_part = xs_all[:R], xs_all[R:]
    CB.reset_launch_counts()
    ys, _ = serve_round(srv, "surrogate", xs)
    counts = CB.launch_counts()
    check(counts["sell_spmm"] == R // width and kernel_launches(counts) == R // width,
          f"serving: {R} requests at width {width} launched {counts}, not sell_spmm once "
          "a flush")
    futs_p = srv.submit_many("surrogate", xs_part)
    check(not any(f.done() for f in futs_p) and srv.flush("surrogate") == width - 1,
          "serving: the partial batch flushed early or answered the wrong count")
    ys_p = [f.result() for f in futs_p]
    counts = CB.launch_counts()
    check(counts["sell_spmm"] == R // width + 1 and kernel_launches(counts) == R // width + 1,
          f"serving: the padded partial flush launched {counts}")
    launches_12a = counts["sell_spmm"]
    err_12a = worst_rel(ys + ys_p, [plan_s(x) for x in xs + xs_part])
    check(err_12a <= TOL["float64"], f"serving: a future differs from plan(x) (kernel 1) "
                                     f"by {err_12a:.3e}")
    ys2, _ = serve_round(srv, "surrogate", xs)
    check(all(torch.equal(a, b) for a, b in zip(ys, ys2)),
          "serving: two servings of the same requests differ in their bits")
    del ys2
    # the served rate over a window of at least SERVE_WINDOW_S a side: rounds
    # of the R requests, the default server and the guardrails-off one
    # (validate="off", resilience disabled: the reference's overhead
    # comparison) in turns, every round's bits checked outside its time
    srv_off = SERVE.BatchingSpMVServer(chip=card, max_batch=width, deadline_s=10.0,
                                       validate="off",
                                       resilience=SERVE.ResiliencePolicy(enabled=False))
    srv_off.register("surrogate", ss)
    walls = {"on": [], "off": []}
    while min(sum(walls["on"]), sum(walls["off"])) < SERVE_WINDOW_S:
        order = ("off", "on") if len(walls["on"]) % 2 else ("on", "off")
        for side in order:
            ys_t, w = serve_round(srv if side == "on" else srv_off, "surrogate", xs)
            walls[side].append(w)
            check(all(torch.equal(a, b) for a, b in zip(ys, ys_t)),
                  f"serving ({side}): round {len(walls[side])} differs in its bits")
    del ys_t
    rounds = len(walls["on"])
    served = {k: {"rounds": len(v), "requests": R * len(v), "seconds": sum(v),
                  "qps": R * len(v) / sum(v), "round_qps_min": R / max(v),
                  "round_qps_median": R / float(np.median(v)), "round_qps_max": R / min(v)}
              for k, v in walls.items()}
    qps = {k: v["qps"] for k, v in served.items()}

    # one flush's device steps, each timed alone on an operand of the flush's
    # shape (CUDA events): the transposing copy out of the staging block,
    # kernel 5 and the verdict; then one flush through the server on the
    # host clock, the rest being what the steps do not explain
    block = torch.stack(xs[:width])
    X_f, _ = SERVE.batching.coalesce(block, width, True)
    Y_f = plan_s.spmm(X_f)
    split = {"coalesce": time_ms(torch, lambda: SERVE.batching.coalesce(block, width, True)),
             "kernel5": time_ms(torch, lambda: plan_s.spmm(X_f)),
             "verdict": time_ms(torch, lambda: V.check_finite_columns(Y_f))}
    del block, X_f, Y_f
    host_ms, wall_ms = [], []
    for _ in range(5):
        srv.submit_many("surrogate", xs[:width - 1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = srv.submit("surrogate", xs[width - 1])   # fills the batch: one flush
        host_ms.append((time.perf_counter() - t0) * 1e3)
        last.result()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    split.update(flush_host_ms=float(np.median(host_ms)), flush_wall_ms=float(np.median(wall_ms)))
    split["rest_ms"] = split["flush_wall_ms"] - (split["coalesce"] + split["kernel5"]
                                                 + split["verdict"])
    st = srv.stats()["surrogate"]
    # the first round, the repeat, the timed ones, the padded partial, the five
    # timed flushes
    n_batches = (2 + rounds) * (R // width) + 1 + 5
    check(st["degraded"] == st["failed"] == st["shed"] == st["retried"] == 0
          and st["batches"] == n_batches and st["kernel"] == "cuda"
          and st["padding_ratio"] == 1 / (n_batches * width),
          f"serving: stats {st} (expected {n_batches} batches, one pad column, no fault)")
    kernel_qps = batch[width]["measured_qps"] if width in batch else None
    out["serving"] = {
        "width": width, "requests": R, "launches_sell_spmm": launches_12a,
        "max_rel_err_vs_plan": err_12a, "served_qps": qps["on"],
        "served_qps_guardrails_off": qps["off"], "served": served, "walls_s": walls,
        "kernel_only_qps_phase8": kernel_qps, "flush_split_ms": split,
        "stats": {k: v for k, v in st.items() if k != "ladder"}, "ladder": list(st["ladder"])}
    log(f"[serve] surrogate SELL C=8 sigma={s_sig} through kernel 5: select_batch_width "
        f"{width} on card_chip(); {R} f64 requests -> {launches_12a} sell_spmm launches "
        f"(one a flush, one padded partial); futures vs plan(x) rel err {err_12a:.1e}; "
        f"served {qps['on']:.0f} SpMV/s over {served['on']['seconds']:.3f} s, {rounds} rounds "
        f"(round min/median/max {served['on']['round_qps_min']:.0f} / "
        f"{served['on']['round_qps_median']:.0f} / {served['on']['round_qps_max']:.0f}); "
        f"guardrails off {qps['off']:.0f} over {served['off']['seconds']:.3f} s "
        f"({served['off']['round_qps_min']:.0f} / {served['off']['round_qps_median']:.0f} / "
        f"{served['off']['round_qps_max']:.0f}; overhead {qps['off'] / qps['on']:.4f}x); "
        f"kernel 5 alone at K={width} {kernel_qps or float('nan'):.0f} SpMV/s (phase 8); one "
        f"flush: coalesce {split['coalesce']:.4f} ms, kernel 5 {split['kernel5']:.4f}, verdict "
        f"{split['verdict']:.4f} (device, each alone), host {split['flush_host_ms']:.4f}, wall "
        f"{split['flush_wall_ms']:.4f}, rest {split['rest_ms']:.4f} ms; ladder "
        f"{list(st['ladder'])}")
    del ys, ys_p, xs_all, xs, xs_part

    # 12b. width 1 on the surrogate (kernel 1), then the exact L = 6 operator
    # (kernel 4) beside the surrogate in one server, flushed by pump()
    solo = SERVE.BatchingSpMVServer(chip=card, max_batch=1)
    solo.register("surrogate", ss)
    xs1 = list(torch.randn((64, args.n), generator=gen_s, device=dev, dtype=f64))
    CB.reset_launch_counts()
    ys1, wall1 = serve_round(solo, "surrogate", xs1)
    counts = CB.launch_counts()
    check(counts["sell_spmv"] == 64 and kernel_launches(counts) == 64,
          f"serving width 1: 64 requests launched {counts}, not sell_spmv once each")
    launches_12b_v = counts["sell_spmv"]
    check(all(torch.equal(y, plan_s(x)) for x, y in zip(xs1, ys1)),
          "serving width 1: a future is not bitwise plan(x)")
    t_k1 = time_ms(torch, lambda: plan_s(xs1[0]))
    st1 = solo.stats()["surrogate"]
    check(st1["fast_path_calls"] == 64 and st1["batches"] == 0, f"serving width 1: {st1}")
    del ys1, xs1
    clock = FakeClock()
    duo = SERVE.BatchingSpMVServer(chip=card, clock=clock)
    duo.register("surrogate", ss)
    rep_x = duo.register("exact", ex6)
    check(rep_x.kernel == rep_x.spmm_kernel == "cuda", f"serving: {ex6_name} runs {rep_x}")
    w_sur, w_ex = (duo.stats()[k]["batch_width"] for k in ("surrogate", "exact"))
    xs_s = list(torch.randn((min(3, w_sur - 1), args.n), generator=gen_s, device=dev, dtype=f64))
    xs_x = list(torch.randn((min(3, w_ex - 1), ex6.shape[0]), generator=gen_s, device=dev,
                            dtype=f64))
    CB.reset_launch_counts()
    fs, fx = duo.submit_many("surrogate", xs_s), duo.submit_many("exact", xs_x)
    check(duo.pump() == 0 and not any(f.done() for f in fs + fx),
          "serving: pump() flushed before the deadline")
    clock.advance(2 * duo.deadline_s)
    check(duo.pump() == len(xs_s) + len(xs_x), "serving: pump() missed a due queue")
    ys_s, ys_x = [f.result() for f in fs], [f.result() for f in fx]
    counts = CB.launch_counts()
    # kernel 4 runs once a column, so the exact operator's partial flush is
    # not padded: one launch a real request
    check(counts["sell_spmm"] == 1 and counts["mf_spmv"] == len(xs_x)
          and kernel_launches(counts) == 1 + len(xs_x),
          f"serving: one pump of both queues launched {counts} (want sell_spmm 1, mf_spmv "
          f"{len(xs_x)}: kernel 4 once a real column)")
    launches_12b_mf = counts["mf_spmv"]
    plan_x6 = duo.plan("exact")
    check(plan_x6.spmm_by_columns and not plan_s.spmm_by_columns,
          "serving: the SpMM entries' column-by-column marks are wrong")
    check(all(torch.equal(y, plan_x6(x)) for x, y in zip(xs_x, ys_x)),
          f"serving: an {ex6_name} future is not bitwise plan(x)")
    err_12b = worst_rel(ys_s, [plan_s(x) for x in xs_s])
    check(err_12b <= TOL["float64"], f"serving: surrogate future vs plan(x) {err_12b:.3e}")
    for name, pad in (("surrogate", 1 - len(xs_s) / w_sur), ("exact", 0.0)):
        st_ = duo.stats()[name]
        check(st_["degraded"] == st_["failed"] == st_["shed"] == 0 and st_["batches"] == 1
              and abs(st_["padding_ratio"] - pad) < 1e-12,
              f"serving: {name} stats {st_} (padding ratio {pad} expected)")
    # the exact operator's flush at full width and at the partial width, on
    # the host clock: K launches of kernel 4 against K times its own time
    xs_w = list(torch.randn((w_ex, ex6.shape[0]), generator=gen_s, device=dev, dtype=f64))
    ex_flush = {}
    for k_ in (w_ex, len(xs_x)):
        walls_ = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fl = duo.submit_many("exact", xs_w[:k_])
            duo.flush("exact")
            fl[-1].result()
            torch.cuda.synchronize()
            walls_.append((time.perf_counter() - t0) * 1e3)
        ex_flush[k_] = {"ms": float(np.median(walls_)),
                        "kernel4_times_k_ms": k_ * mf_timed["exact"]["ms"]}
    del xs_w, fl
    out["serving"].update(
        width1={"requests": 64, "ms_per_request": wall1 / 64 * 1e3, "kernel1_plan_ms": t_k1,
                "launches_sell_spmv": launches_12b_v},
        two_operators={"widths": {"surrogate": w_sur, "exact": w_ex},
                       "launches": {"sell_spmm": counts["sell_spmm"],
                                    "mf_spmv": launches_12b_mf},
                       "surrogate_rel_err": err_12b, "exact_flush": ex_flush})
    log(f"[serve] width 1: 64 requests, {wall1 / 64 * 1e3:.4f} ms a request against "
        f"plan(x) {t_k1:.4f} ms (kernel 1), {launches_12b_v} sell_spmv launches, bitwise "
        f"plan(x); surrogate + {ex6_name} in one server, widths {w_sur} / {w_ex}: pump() "
        f"past the deadline flushed both, sell_spmm {counts['sell_spmm']}, mf_spmv "
        f"{launches_12b_mf} (kernel 4 once a real column, no pad), exact futures bitwise "
        f"plan(x); exact flush " + ", ".join(
            f"K={k_}: {v['ms']:.4f} ms (K x kernel 4 {v['kernel4_times_k_ms']:.4f})"
            for k_, v in ex_flush.items()))
    del ys_s, ys_x, xs_s, xs_x, fs, fx

    # 12c. resilience on the card, on a small corpus spec (SELL kernels 1, 5):
    # the loop_reference rung is a host loop, never driven at full size
    cm = CORPUS.build("holstein_surrogate")
    n_c = cm.shape[1]
    clock_c = FakeClock()

    def small(**kw):
        s_ = SERVE.BatchingSpMVServer(chip=card, max_batch=4, deadline_s=60.0,
                                      clock=clock_c, **kw)
        s_.register("c", cm, config=PlanConfig(format="sell"))
        return s_

    xs_c = list(torch.randn((4, n_c), generator=gen_s, device=dev, dtype=f64))
    s1 = small()
    check(s1.plan("c").report.spmm_kernel == "cuda", "resilience: the small plan is not cuda")
    clean = [f.result() for f in s1.submit_many("c", xs_c)]
    with faults.inject("serve.flush", error=RuntimeError("transient"), times=1) as sp:
        got = [f.result() for f in s1.submit_many("c", xs_c)]
    check(sp.fired == 1 and s1.stats()["c"]["retried"] == 1
          and all(torch.equal(a, b) for a, b in zip(clean, got)),
          "resilience: a transient serve.flush error was not retried bit for bit")
    with faults.inject("plan.spmm", nonfinite=True, times=None, column=2):
        futs = s1.submit_many("c", xs_c)
    errs = [f.error() for f in futs]
    check(isinstance(errs[2], SERVE.KernelFault) and errs[2].nonfinite
          and all(errs[i] is None and torch.equal(futs[i].result(), clean[i]) for i in (0, 1, 3)),
          f"resilience: poison isolation gave {errs}")
    # a cuda plan has no plain rung below it: a persistent kernel failure
    # is a KernelFault on every request, never an answer from a plain version
    s2 = small(resilience=SERVE.ResiliencePolicy(max_retries=0, breaker_threshold=1))
    check(s2.stats()["c"]["ladder"] == (), f"resilience: ladder {s2.stats()['c']['ladder']}")
    with faults.inject("plan.spmm", error=RuntimeError("cuda broken"), times=None,
                       when=lambda ctx: ctx.get("kernel") == "cuda"):
        errs = [f.error() for f in s2.submit_many("c", xs_c)]
    st2 = s2.stats()["c"]
    check(all(isinstance(e, SERVE.KernelFault) and e.kernel == "cuda" for e in errs)
          and st2["degraded"] == 0 and st2["failed"] == len(xs_c)
          and s2.plan("c").report.kernel == "cuda",
          f"resilience: a persistent cuda failure gave {errs}, stats {st2}")
    check(all(torch.equal(f.result(), c) for f, c in zip(s2.submit_many("c", xs_c), clean)),
          "resilience: the operator did not serve the clean bits once the fault was gone")
    try:
        with faults.inject("serve.queue_full", error=SERVE.BackpressureError("injected")):
            s1.submit("c", xs_c[0])
        shed = False
    except SERVE.BackpressureError:
        shed = True
    check(shed and s1.stats()["c"]["shed"] == 1, "resilience: queue_full did not shed")
    f_late = s1.submit("c", xs_c[0], timeout_s=0.1)
    clock_c.advance(1.0)
    s1.flush("c")
    check(isinstance(f_late.error(), SERVE.DeadlineExceeded),
          "resilience: a request past its timeout was not shed")
    faults.reset()
    s3 = small()
    check(all(torch.equal(f.result(), c) for f, c in zip(s3.submit_many("c", xs_c), clean)),
          "resilience: after faults.reset() a fresh registration changed the bits")
    out["serving"].update(resilience={"spec": "holstein_surrogate", "rows": n_c,
                                      "checks": 6},
                          host_s=time.perf_counter() - t12)
    for name, n_ in (("sell_spmm", launches_12a), ("sell_spmv", launches_12b_v),
                     ("mf_spmv", launches_12b_mf)):
        record(name, launches_serving=n_)
    log(f"[serve] resilience on the card ({cm.shape[0]} rows, sell): transient retry "
        f"bitwise, column 2 poisoned -> KernelFault alone, persistent cuda failure -> "
        f"KernelFault on each request (no plain rung), then clean bits, queue_full shed, "
        f"timeout -> DeadlineExceeded, bits back after reset; phase 12 took "
        f"{out['serving']['host_s']:.1f} s")
    del srv, srv_off, solo, duo, s1, s2, s3

    # --- 13. distributed SpMV on a 4-shard mesh of the card ------------------------
    # P = 4 shards share cuda:0 (the single-controller mesh's repeatable
    # devices): every pass of an x shard stays on the card, so nothing is
    # communicated and the times below are no scaling result
    t13 = time.perf_counter()
    mesh4 = DIST.make_mesh_1d(n_devices=4, device=dev)
    P4 = len(mesh4.devices)
    plan_csr = SpMVPlan.compile(m, PlanConfig(format="csr"))   # phase 4b's, kernel 3
    rp_h, ci_h = F._np(m.row_ptr).astype(np.int64), F._np(m.col_idx)
    rows_h = np.repeat(np.arange(args.n), np.diff(rp_h))
    v_h = F._np(m.val).astype(np.float64)

    def host_product(a):
        """The f64 product A @ a on the host ((n,) or (n, K))."""
        if a.ndim == 1:
            return np.bincount(rows_h, weights=v_h * a[ci_h], minlength=args.n)
        return np.stack([np.bincount(rows_h, weights=v_h * a[ci_h, j], minlength=args.n)
                         for j in range(a.shape[1])], axis=1)

    gen13 = np.random.default_rng(13)
    x13 = gen13.standard_normal(args.n)
    X13 = gen13.standard_normal((args.n, 16))
    t0 = time.perf_counter()
    want13 = {"x": torch.from_numpy(host_product(x13)).to(dev),
              "X": torch.from_numpy(host_product(X13)).to(dev)}
    host_product_s = time.perf_counter() - t0
    x13_d, X13_d = torch.from_numpy(x13).to(dev), torch.from_numpy(X13).to(dev)
    y13_csr = plan_csr(x13_d)

    def check13(what, got, want):
        """rel err against an f64 reference, within TOL of ``got``'s type."""
        acc = str(got.dtype).replace("torch.", "")
        err, rel = rel_err(torch, got, want)
        ok = bool(torch.isfinite(got).all()) and rel <= TOL[acc]
        checks.append({"kernel": "distributed", "case": what, "acc": acc,
                       "max_abs_err": err, "rel_err": rel, "ok": ok})
        check(ok, f"distributed {what}: rel err {rel:.3e} > {TOL[acc]:g}")
        return err

    def blocks_of(p_):
        return sum(op is not None for row in p_.operands for op in row)

    def moved_bytes(p_, row_bytes):
        """Bytes an x shard pass moves between distinct devices in one call
        (0 when every shard sits on one card)."""
        d_, cs_ = p_.mesh.devices, p_.blocks.col_shard
        if p_.variant == "allgather":
            return sum(P4 * cs_ * row_bytes for j in range(P4) if d_[j] != d_[0])
        return (P4 - 1) * sum(cs_ * row_bytes for j in range(P4) if d_[j] != d_[(j + 1) % P4])

    # 13a. the packings' host seconds (the plans below pack again, cached)
    pack_s = {}
    for pk in DP.SLAB_FORMATS:
        for lc in (False, True):
            t0 = time.perf_counter()
            b_ = DP.pack_shard_slabs(m, P4, balance="nnz", pack=pk, local_cols=lc)
            pack_s[f"{pk}/{'ring' if lc else 'allgather'}"] = {
                "s": time.perf_counter() - t0, "stored_over_nnz": b_.stored / m.nnz}
            del b_
    log("[dist] packing at N=%d, P=4, nnz cut: " % args.n + ", ".join(
        f"{k} {v['s']:.2f} s ({v['stored_over_nnz']:.2f}x nnz stored)"
        for k, v in pack_s.items()) + f"; host f64 products {host_product_s:.1f} s")
    dist_rows, dplans = [], {}
    for bal in ("nnz", "rows"):
        for slab in ("auto", "ell"):
            for variant in DP.VARIANTS:
                t0 = time.perf_counter()
                p_ = DP.compile_distributed_spmv_plan(m, mesh4, variant=variant, balance=bal,
                                                      slab_format=slab)
                compile_s = time.perf_counter() - t0
                dplans[(bal, slab, variant)] = p_
                what = f"{variant} {bal} {slab}->{p_.slab_format}"
                check(p_.slab_backend == "cuda", f"distributed {what}: runs {p_.slab_backend}")
                nb = blocks_of(p_)
                check(nb <= (P4 if variant == "allgather" else P4 * P4) and nb > 0,
                      f"distributed {what}: {nb} slab operands")
                CB.reset_launch_counts()
                y_ = p_(x13_d)
                c1 = CB.launch_counts()
                Y_ = p_.spmm(X13_d)
                c2 = CB.launch_counts()
                check(c1["sell_spmv"] == nb and sum(c1.values()) == nb,
                      f"distributed {what}: plan(x) launched {c1}, want sell_spmv {nb}")
                check(c2["sell_spmm"] == nb and sum(c2.values()) == 2 * nb,
                      f"distributed {what}: plan.spmm launched {c2}, want sell_spmm {nb}")
                err = max(check13(f"{what} f64 vs host", y_, want13["x"]),
                          check13(f"{what} f64 vs csr plan", y_, y13_csr),
                          check13(f"{what} f32 vs host", p_(x13_d.float()), want13["x"]),
                          check13(f"{what} spmm K=16 f64 vs host", Y_, want13["X"]))
                check(torch.equal(p_(x13_d), y_) and torch.equal(p_.spmm(X13_d), Y_),
                      f"distributed {what}: two calls differ in their bits")
                read = sum(op.nbytes for row in p_.operands for op in row if op is not None)
                r_ = {"variant": variant, "balance": bal, "slab_format": slab,
                      "pack": p_.slab_format, "launches_spmv": nb, "max_abs_err": err,
                      "ms": time_ms(torch, lambda: p_(x13_d)),
                      "spmm_ms": time_ms(torch, lambda: p_.spmm(X13_d), reps=10),
                      "compile_s": compile_s, "imbalance": p_.imbalance,
                      "local_fraction": p_.local_fraction,
                      "modelled_matrix_bytes": p_.traffic["hbm_stream"],
                      "read_matrix_bytes": read,
                      "modelled_collective_bytes": p_.traffic["collective"],
                      "moved_bytes": moved_bytes(p_, 8)}
                dist_rows.append(r_)
                del y_, Y_
                log(f"[dist] {what}: {r_['ms']:.4f} ms/SpMV, spmm K=16 {r_['spmm_ms']:.4f} ms; "
                    f"{nb} kernel launches a call; compile {compile_s:.2f} s; matrix bytes "
                    f"modelled {r_['modelled_matrix_bytes'] / 1e6:.1f} MB, read "
                    f"{read / 1e6:.1f} MB; collective modelled "
                    f"{r_['modelled_collective_bytes'] / 1e6:.1f} MB, moved "
                    f"{r_['moved_bytes']} B; imbalance {p_.imbalance:.5f}, local "
                    f"{p_.local_fraction:.4f}; max abs err {err:.2e}")
    local_ms = {"sell": time_ms(torch, lambda: plan_s(x13_d)),
                "csr": time_ms(torch, lambda: plan_csr(x13_d))}
    # each shard's slabs alone: the measured straggler of each cut
    straggler = {}
    for bal in ("nnz", "rows"):
        for variant in ("allgather", "ring"):
            p_ = dplans[(bal, "auto", variant)]
            mult, cs_ = p_.mults["spmv"], p_.blocks.col_shard
            xp = DIST.pad_x(x13_d, P4 * cs_)

            def shard_work(p):
                def run():
                    y_ = None
                    for s in range(p_.blocks.q_blocks):
                        q = (p + s) % p_.blocks.q_blocks
                        op = p_.operands[p][q]
                        xs = xp if variant == "allgather" else xp[q * cs_:(q + 1) * cs_]
                        if op is not None:
                            y_ = mult(op, xs, add_to=y_)
                return run

            ms_ = [time_ms(torch, shard_work(p)) for p in range(P4)]
            pred = [r.times[p_.slab_format] for r in p_.shard_reports]
            # kernel 5 alone on each shard's slabs (K = 16)
            mm, Xp = p_.mults["spmm"], DIST.pad_x(X13_d, P4 * cs_)
            mm_ms = [time_ms(torch, lambda p=p: [
                mm(p_.operands[p][q], Xp if variant == "allgather" else
                   Xp[q * cs_:(q + 1) * cs_]) for q in range(p_.blocks.q_blocks)
                if p_.operands[p][q] is not None], reps=10) for p in range(P4)]
            del Xp
            straggler[f"{bal}/{variant}"] = {
                "shard_ms": ms_, "max_over_mean": max(ms_) / float(np.mean(ms_)),
                "spmm_shard_ms": mm_ms,
                "blocks_per_shard": [sum(op is not None for op in row) for row in p_.operands],
                "modelled_imbalance": p_.imbalance,
                "predicted_max_over_mean": max(pred) / float(np.mean(pred)),
                "partition_imbalance": DIST.partition_imbalance(m, p_.blocks.bounds)}
            log(f"[dist] straggler {bal} cut, {variant} slabs ({p_.slab_format}): shard ms "
                + " / ".join(f"{t:.4f}" for t in ms_)
                + f" (kernel 5 at K=16: " + " / ".join(f"{t:.4f}" for t in mm_ms)
                + f"; blocks {straggler[f'{bal}/{variant}']['blocks_per_shard']})"
                + f"; max/mean {straggler[f'{bal}/{variant}']['max_over_mean']:.4f} beside the "
                f"modelled imbalance {p_.imbalance:.5f} (nnz cut of the bounds "
                f"{straggler[f'{bal}/{variant}']['partition_imbalance']:.5f})")
    log(f"[dist] local plans on the same x: sell {local_ms['sell']:.4f} ms, csr "
        f"{local_ms['csr']:.4f} ms (kernel 3)")

    # 13b. Lanczos through lanczos(mesh=): the overlap plan, nnz cut, auto pack
    plan_l = DP.compile_distributed_spmv_plan(m, mesh4, variant="overlap")
    nb_l = blocks_of(plan_l)
    CB.reset_launch_counts()
    res_d = lanczos(m, args.n, m=args.lanczos_steps, mesh=mesh4, v0=v0)
    counts = CB.launch_counts()
    launches_13b = counts["sell_spmv"]
    check(launches_13b == res_d.n_spmv * nb_l and kernel_launches(counts) == launches_13b,
          f"distributed Lanczos: {counts} for {res_d.n_spmv} SpMVs x {nb_l} slabs")
    res_cl = lanczos(plan_csr, args.n, m=args.lanczos_steps, v0=v0)
    da = float(np.max(np.abs(res_d.alphas - res_cl.alphas) / np.abs(res_cl.alphas)))
    db = float(np.max(np.abs(res_d.betas - res_cl.betas) / np.abs(res_cl.betas)))
    de = abs(float(res_d.eigenvalues[0]) - float(res_cl.eigenvalues[0]))
    check(res_d.alphas.shape == res_cl.alphas.shape and da <= 1e-8 and db <= 1e-8
          and de <= 1e-10 * max(1.0, abs(float(res_cl.eigenvalues[0]))),
          f"distributed Lanczos vs the csr plan: alpha {da:.2e}, beta {db:.2e}, E0 {de:.2e}")
    _, spmv_d, wall_d = timed_lanczos(plan_l, v0, True)
    # phase 3's hybrid plan again, now: its step in the same warm state
    _, spmv_h, wall_h = timed_lanczos(SpMVPlan.compile(hyb, PlanConfig()), v0, True)
    lanczos13 = {"steps": res_d.n_spmv, "E0": float(res_d.eigenvalues[0]),
                 "alpha_rel_diff_vs_csr": da, "beta_rel_diff_vs_csr": db, "E0_diff": de,
                 "launches": launches_13b, "spmv_ms_median": float(np.median(spmv_d)),
                 "step_ms": wall_d / res_d.n_spmv,
                 "phase3_spmv_ms_median": main["spmv_ms_median"],
                 "phase3_step_ms": main["lanczos_wall_ms"] / main["steps"],
                 "hybrid_now_spmv_ms_median": float(np.median(spmv_h)),
                 "hybrid_now_step_ms": wall_h / len(spmv_h)}
    log(f"[dist] lanczos(mesh=4 shards, overlap, {plan_l.slab_format}): {res_d.n_spmv} steps, "
        f"{launches_13b} sell_spmv launches ({nb_l} a SpMV); vs csr plan alpha {da:.1e}, "
        f"beta {db:.1e}, E0 {de:.1e}; {lanczos13['spmv_ms_median']:.4f} ms/SpMV, "
        f"{lanczos13['step_ms']:.4f} ms/step (phase 3: {main['spmv_ms_median']:.4f}, "
        f"{lanczos13['phase3_step_ms']:.4f}; its hybrid plan rerun now: "
        f"{lanczos13['hybrid_now_spmv_ms_median']:.4f}, {lanczos13['hybrid_now_step_ms']:.4f})")

    # 13c. serving over the mesh: a flush is one plan.spmm, kernel 5 once a slab
    srv13 = SERVE.BatchingSpMVServer(chip=card, deadline_s=10.0)
    rep13 = srv13.register_distributed("surrogate", m, mesh=mesh4, variant="overlap")
    plan13 = srv13.plan("surrogate")
    nb13 = blocks_of(plan13)
    w13 = srv13.stats()["surrogate"]["batch_width"]
    check(rep13.kernel == "overlap" and plan13.slab_backend == "cuda" and w13 > 1,
          f"distributed serving: {rep13}, width {w13}")
    gen13t = torch.Generator(device=dev).manual_seed(13)
    xs13 = list(torch.randn((w13, args.n), generator=gen13t, device=dev, dtype=torch.float64))
    CB.reset_launch_counts()
    ys13 = [f.result() for f in srv13.submit_many("surrogate", xs13)]
    counts = CB.launch_counts()
    launches_13c = counts["sell_spmm"]
    check(launches_13c == nb13 and kernel_launches(counts) == nb13,
          f"distributed serving: one flush launched {counts}, want sell_spmm {nb13}")
    err13 = max(rel_err(torch, y, plan13(x))[1] for x, y in zip(xs13, ys13))
    check(err13 <= TOL["float64"], f"distributed serving: futures vs plan(x) {err13:.3e}")
    st13 = srv13.stats()["surrogate"]
    mesh_stats = {k: st13[k] for k in ("variant", "parts", "slab_format", "imbalance",
                                       "local_fraction", "collective_bytes_per_call")}
    check(st13["batches"] == 1 and st13["failed"] == 0 and st13["ladder"] == ()
          and st13["parts"] == P4, f"distributed serving: stats {st13}")
    del ys13, xs13
    # faults on a small corpus spec: transient dist.spmm retried bitwise; a
    # dead shard a KernelFault on each request (no plain rung under cuda)
    cm13 = CORPUS.build("holstein_surrogate")
    xs_c13 = list(torch.randn((4, cm13.shape[1]), generator=gen13t, device=dev,
                              dtype=torch.float64))

    def small13(pol):
        s_ = SERVE.BatchingSpMVServer(chip=card, max_batch=4, deadline_s=60.0,
                                      clock=FakeClock(), resilience=pol)
        s_.register_distributed("c", cm13, mesh=mesh4, variant="overlap")
        return s_

    s13a = small13(SERVE.ResiliencePolicy(max_retries=1))
    clean13 = [f.result() for f in s13a.submit_many("c", xs_c13)]
    with faults.inject("dist.spmm", error=RuntimeError("transient"), times=1) as sp:
        got13 = [f.result() for f in s13a.submit_many("c", xs_c13)]
    check(sp.fired == 1 and s13a.stats()["c"]["retried"] == 1
          and all(torch.equal(a, b) for a, b in zip(clean13, got13)),
          "distributed resilience: a transient dist.spmm failure was not retried bitwise")
    s13b = small13(SERVE.ResiliencePolicy(max_retries=0, breaker_threshold=1))
    with faults.inject("dist.spmm", error=faults.ShardDeath(2), times=None):
        errs13 = [f.error() for f in s13b.submit_many("c", xs_c13)]
    st13b = s13b.stats()["c"]
    check(all(isinstance(e, SERVE.KernelFault) and isinstance(e.__cause__, faults.ShardDeath)
              for e in errs13) and st13b["degraded"] == 0 and st13b["failed"] == 4
          and s13b.plan("c").slab_backend == "cuda",
          f"distributed resilience: a dead shard gave {errs13}, stats {st13b}")
    faults.reset()
    check(all(torch.equal(f.result(), c) for f, c in zip(s13b.submit_many("c", xs_c13),
                                                          clean13)),
          "distributed resilience: the bits did not come back after faults.reset()")
    record("sell_spmv", launches_distributed=launches_13b)
    record("sell_spmm", launches_distributed=launches_13c)
    out["distributed"] = {
        "mesh": [str(d) for d in mesh4.devices], "packing": pack_s,
        "host_product_s": host_product_s, "plans": dist_rows, "local_ms": local_ms,
        "straggler": straggler, "lanczos": lanczos13,
        "serving": {"width": w13, "launches_sell_spmm": launches_13c, "blocks": nb13,
                    "max_rel_err_vs_plan": err13, "mesh_stats": mesh_stats},
        "host_s": time.perf_counter() - t13}
    log(f"[dist] serving: register_distributed on 4 shards, width {w13}: one flush = "
        f"{launches_13c} sell_spmm launches (one a slab), futures vs plan(x) {err13:.1e}; "
        f"mesh stats {mesh_stats}; resilience: transient retry bitwise, ShardDeath -> "
        f"KernelFault x4, no degrade, clean bits after reset; phase 13 took "
        f"{out['distributed']['host_s']:.1f} s")
    del srv13, s13a, s13b, dplans, plan13, plan_l

    # --- 14. the LM serving path: Qwen3-0.6B at full width -----------------------
    out["lm"] = lm_phase(torch, dev, smi, record, compare)

    # --- 15. the training path: Qwen3-0.6B at full width -----------------------------
    out["train"] = train_phase(torch, dev, smi)

    # --- 16. the dry-run and roofline tools: the meta sweep, Qwen3-0.6B's step --------
    out["dryrun"] = dryrun_phase(torch, dev, smi, meta_sweep)

    # --- 17. the examples at the paper's scale ------------------------------------------
    out["examples"] = examples_phase(torch, dev, smi, args.n)
    for name in ("sell_spmv", "dia_spmv", "csr_spmv", "mf_spmv", "sell_spmm", "bell_spmm",
                 "stream_triad"):
        record(name, launches_examples=out["examples"]["launches"].get(name, 0))

    # --- report -----------------------------------------------------------------
    names = ("sell_spmv", "dia_spmv", "csr_spmv", "mf_spmv", "sell_spmm", "stream_triad",
             "gather_scp", "bell_spmm", "grouped_gemm", "grouped_gemm_wgmma", "mf_product")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches_serving: phase 12's count (0 for a kernel off the serving path);
    # launches_distributed: phase 13's (kernel 1 in its Lanczos, kernel 5 in its
    # served flush; 0 for a kernel off the distributed path)
    # launches_lm: phase 14's (the pruned FFN weight's kernel; 0 elsewhere)
    # launches_examples: phase 17's, summed over the seven examples
    kernels = [{**{k: rows[n].get(k) for k in keys},
                "launches_serving": rows[n].get("launches_serving", 0),
                "launches_distributed": rows[n].get("launches_distributed", 0),
                "launches_lm": rows[n].get("launches_lm", 0),
                "launches_examples": rows[n].get("launches_examples", 0)}
               for n in names]
    for kr in kernels:
        check(all(kr[k] is not None for k in keys if k != "library_ms")
              and (kr["library_ms"] is not None or kr["name"] == "gather_scp"),
              f"incomplete kernel row {kr}")
        check(kr["launches"] > 0, f"{kr['name']} was never launched on its path")
        check(kr["launches_serving"] > 0 or kr["name"] not in ("sell_spmm", "sell_spmv",
                                                               "mf_spmv"),
              f"{kr['name']} was never launched on the serving path")
        check(kr["launches_distributed"] > 0 or kr["name"] not in ("sell_spmm", "sell_spmv"),
              f"{kr['name']} was never launched on the distributed path")
    check(sum(kr["launches_lm"] for kr in kernels
              if kr["name"] in ("bell_spmm", "sell_spmm")) > 0,
          "no sparse-weight kernel was launched on the LM path")
    for kr in kernels:
        # bell_spmm runs when serve_sparse's advisor picks bsr (phase 17e checks it);
        # no example builds the electron x phonon operator of mf_product
        check(kr["launches_examples"] > 0 or kr["name"] in (
            "gather_scp", "grouped_gemm", "grouped_gemm_wgmma", "bell_spmm", "mf_product"),
              f"{kr['name']} was never launched by the examples")
    out["kernels"] = [rows[n] for n in names]
    for kr in out["kernels"]:
        kr["bound_ms_at_measured_bw"] = kr["bound_ms"] * H100.hbm_bytes_per_s / \
            chip.hbm_bytes_per_s if kr["bound_by"] == "bytes" else kr["bound_ms"]
    # kernel 4 at both of its shapes: the share of the byte bound, at the data
    # sheet's rate and at this run's triad rate
    for r in mf_timed.values():
        r["bound_ms_at_measured_bw"] = r["bytes"] / chip.hbm_bytes_per_s * 1e3
        log(f"[mf] {r['shape']}: kernel {r['ms']:.4f} ms = {100 * r['bound_ms'] / r['ms']:.1f} "
            f"% of its byte bound {r['bound_ms']:.4f} ms at 3.35 TB/s, "
            f"{100 * r['bound_ms_at_measured_bw'] / r['ms']:.1f} % at the triad rate; plan "
            f"call {r['plan_ms']:.4f}, cuSPARSE {r['library_ms']:.4f}, plain "
            f"{r['plain_ms']:.4f} ms")
    out["checks"] = checks
    out["wall_s"] = time.perf_counter() - t_start
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    for kr in out["kernels"]:
        lib_ms = "none" if kr["library_ms"] is None else f"{kr['library_ms']:.4f}"
        if "library_f32_ms" in kr:
            lib_ms += f", f32 {kr['library_f32_ms']:.4f}"
        if "library_f64_ms" in kr:
            lib_ms += f"; f64 kernel {kr['ms_f64']:.4f}, library {kr['library_f64_ms']:.4f}"
        log(f"[kernel] {kr['name']:12s} {kr['ms']:.4f} ms (plain {kr['plain_ms']:.4f}, "
            f"library {lib_ms}, bound {kr['bound_ms']:.4f} by {kr['bound_by']}, "
            f"{kr['bound_ms_at_measured_bw']:.4f} at the measured triad rate); "
            f"{kr['launches']} launches on its path; {kr['shape']}")
    log(f"[done] {out['wall_s']:.1f} s; card: {smi}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
