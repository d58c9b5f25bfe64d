"""Distributed SpMV plans: compile the partition once, overlap the exchange
of x with the local work.

Port of ``repro.core.distributed_plan``.  The paper's parallel story
(section 5) is that SpMV across NUMA domains is bound by non-local accesses
to the shared input vector and by load imbalance.  Schubert et al.
(arXiv:1106.5908) overlap the exchange of remote x entries with the
multiplication of the purely local part; Kreutzer et al. (arXiv:1307.6209)
choose the slab storage per partition.  On a 1-D mesh (``core.distributed.
Mesh``: a tuple of devices, which may repeat):

* **Compile time** -- rows are cut by ``nnz_balanced_partition`` (or by
  rows); each shard's row block is split against the mesh's column blocks
  (the block on the shard's own x shard is the local one); the perfmodel
  prices the slab packings (padded ELL, flat SELL-C) per partition and the
  plan commits to the one with the fastest straggler; the slabs are packed
  (vectorized, bitwise the reference's arrays) and placed on the shards'
  devices once, as the operands of the slab backend
  (``kernels.slab``: ``torch``, ``loop_reference`` or the ``cuda`` SELL
  kernels 1 and 5).
* **Run time** -- three executor variants over the same layout:

  - ``allgather``: each shard sees the whole padded x, one slab multiply;
  - ``ring``: P - 1 steps of (multiply the column block of the x shard
    held, pass the shard to the previous shard's device), then the last
    block; the blocks are added in the reference's order, src = (me + s) %
    P;
  - ``overlap``: the ring with the first pass issued before the local
    block's multiply, and every later pass before that step's multiply.

  A pass is ``xs.to(device, non_blocking=True)``: a no-op on the same
  device, so P shards on one card run the same code as P cards; on
  distinct cards ``overlap`` issues its passes on a side stream with an
  event that the next step waits on.  The global y is rebuilt by the
  reference's inverse-map gather.

Every variant exists as SpMV (``plan(x)``) and SpMM (``plan.spmm(X)``);
plans are memoized on the matrix container.  ``plan(x)`` / ``plan.spmm(X)``
pass the ``dist.spmv`` / ``dist.spmm`` fault points.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels import registry as R
from ..kernels.accum import acc_dtype
from ..kernels.slab import SlabMeta, slab_operands
from ..testing import faults
from ..utils.hw import H100, ChipSpec
from . import perfmodel as PM
from .distributed import (Mesh, block_entries, block_lengths, ell_pack, make_mesh_1d,
                          pad_x, partition_bounds, row_map_of, sell_pack)
from .formats import COO, CSR, ELL, SELL, _np
from .plan import PlanReport, as_operand

SLAB_FORMATS = ("ell", "sell")
VARIANTS = ("allgather", "ring", "overlap")

# build counters: regression tests assert each shard is packed exactly once
# per (matrix, plan key)
_PACK_STATS = {"shard_packs": 0, "format_selections": 0}


def pack_stats() -> dict:
    """Copy of the shard-packing build counters (for caching regressions)."""
    return dict(_PACK_STATS)


# ---------------------------------------------------------------------------
# per-shard format selection (perfmodel-driven, Kreutzer-style)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardReport:
    """What the model saw and chose for one row partition."""

    part: int
    rows: int
    nnz: int
    local_nnz: int          # entries hitting the shard's own x block
    remote_nnz: int         # entries needing communicated x shards
    format: str             # the model's per-shard choice
    predicted_time_s: float  # of the chosen format
    times: dict             # {format: predicted time} for all candidates


def plan_shard_formats(m: CSR, bounds: np.ndarray, *, C: int = 8,
                       am: PM.AccessModel | None = None, chip: ChipSpec = H100,
                       formats: tuple = SLAB_FORMATS) -> list[ShardReport]:
    """The roofline over each partition's row-length profile: ELL pays the
    partition's padding ratio, flat SELL only per-chunk padding plus the
    row-index stream of a segment sum (``perfmodel.balance_slab``).
    Returns one ``ShardReport`` per partition."""
    _PACK_STATS["format_selections"] += 1
    if am is None:
        am = PM.access_model_for(m, chip)
    parts = len(bounds) - 1
    lens = m.row_lengths()
    rp = _np(m.row_ptr).astype(np.int64)
    ci = _np(m.col_idx)
    cs = -(-m.shape[1] // parts)
    reports = []
    for p in range(parts):
        r0, r1 = int(bounds[p]), int(bounds[p + 1])
        lens_p = lens[r0:r1]
        nnz_p = int(lens_p.sum())
        npr = float(lens_p.mean()) if lens_p.size else 0.0
        seg = ci[rp[r0]:rp[r1]]
        local = int(((seg >= p * cs) & (seg < (p + 1) * cs)).sum())
        times = {}
        for fmt in formats:
            if fmt == "ell":
                pad = PM.ell_pad_ratio(lens_p)
            elif fmt == "sell":
                pad = PM.sell_pad_ratio(lens_p, C, max(1, len(lens_p)))
            else:
                raise ValueError(f"unknown slab format {fmt!r}")
            bal = PM.balance_slab(fmt, am, pad, npr)
            times[fmt] = PM.predict(fmt, bal, max(1, nnz_p), chip).time_s
        best = min(times, key=times.get)
        reports.append(ShardReport(part=p, rows=r1 - r0, nnz=nnz_p, local_nnz=local,
                                   remote_nnz=nnz_p - local, format=best,
                                   predicted_time_s=times[best], times=times))
    return reports


def select_slab_format(reports: list[ShardReport], formats: tuple = SLAB_FORMATS) -> str:
    """One slab format for every shard: the one minimizing the straggler's
    (max over shards) predicted time."""
    return min(formats, key=lambda f: max(r.times[f] for r in reports))


# ---------------------------------------------------------------------------
# shard slab containers + packing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardSlabs:
    """Row-partitioned matrix packed as P stacked per-shard slabs (host
    numpy arrays).

    ``q`` indexes column blocks: ``q_blocks == 1`` stores each row block
    whole with global column indices (the allgather layout); ``q_blocks ==
    parts`` splits it against the mesh's x shards with shard-local column
    indices (the ring / overlap layout, block ``q == p`` local).

    ``pack == "ell"``: col/val are (P, Q, rows_pp, W) padded 2-D slabs.
    ``pack == "sell"``: col/val/rid are (P, Q, L) flat SELL-C slabs -- rows
    sorted by length within the partition, chunked by C, each chunk padded
    to its own width, all-empty chunks skipped, stored chunk-column-major;
    ``rid`` holds partition-local row ids (pad -> rows_pp).
    """

    pack: str
    col: np.ndarray
    val: np.ndarray
    rid: np.ndarray | None     # flat pack only
    row_map: np.ndarray        # (P, rows_pp) global row ids (pad -> n_rows)
    bounds: np.ndarray         # (P+1,) row partition bounds
    col_shard: int             # x shard length (padded)
    rows_pp: int
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def parts(self) -> int:
        return int(self.col.shape[0])

    @property
    def q_blocks(self) -> int:
        return int(self.col.shape[1])

    @property
    def stored(self) -> int:
        """Streamed (padded) elements per SpMV across all shards."""
        return int(np.prod(self.col.shape))


def pack_shard_slabs(m: CSR, parts: int, *, balance: str = "nnz", pack: str = "ell",
                     local_cols: bool = False, C: int = 8,
                     bounds: np.ndarray | None = None) -> ShardSlabs:
    """Partition ``m`` into P row blocks and pack each as a slab.

    ``local_cols=False`` produces the allgather layout (one q block, global
    column ids); ``local_cols=True`` the ring / overlap layout (P q blocks,
    ids local to each x shard).  Each shard is packed once a call; plan
    memoization keeps it once per (matrix, key)."""
    if pack not in SLAB_FORMATS:
        raise ValueError(f"unknown slab pack {pack!r}")
    if bounds is None:
        bounds = partition_bounds(m, parts, balance)
    _PACK_STATS["shard_packs"] += parts
    e = block_entries(m, bounds, local_cols)
    row_map = row_map_of(e.bounds, e.rows_pp, m.n_rows)
    meta = (row_map, bounds, e.col_shard, e.rows_pp, m.n_rows, m.shape[1], m.nnz)
    if pack == "ell":
        col, val = ell_pack(e)
        return ShardSlabs("ell", col, val, None, *meta)
    col, val, rid = sell_pack(e, C)
    return ShardSlabs("sell", col, val, rid, *meta)


# ---------------------------------------------------------------------------
# the executors (3 variants x {spmv, spmm})
# ---------------------------------------------------------------------------


class _SidePass:
    """The overlap variant's pass between two distinct CUDA devices: the
    copy runs on side streams of both devices, ordered after the work that
    produced the shard, and the consumer waits on its event."""

    def __init__(self):
        self._streams: dict = {}

    def _side(self, dev: torch.device):
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(device=dev)
        return self._streams[dev]

    def send(self, t: torch.Tensor, dst: torch.device):
        """(the shard on ``dst``, the event to wait on or None)."""
        if t.device == dst:
            return t, None
        if t.device.type != "cuda" or dst.type != "cuda":
            return t.to(dst), None
        s_src, s_dst = self._side(t.device), self._side(dst)
        s_src.wait_stream(torch.cuda.current_stream(t.device))
        s_dst.wait_stream(torch.cuda.current_stream(dst))
        with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
            out = t.to(dst, non_blocking=True)
        t.record_stream(s_src)
        ev = torch.cuda.Event()
        ev.record(s_dst)
        return out, ev

    @staticmethod
    def wait(t: torch.Tensor, ev) -> torch.Tensor:
        if ev is not None:
            cur = torch.cuda.current_stream(t.device)
            cur.wait_event(ev)
            t.record_stream(cur)
        return t


def _make_executor(blocks: ShardSlabs, devices: tuple, variant: str, operands: tuple,
                   mult, value_dtype: torch.dtype):
    """``run(x) -> y`` of one variant: ``x`` (n[, K]) on the mesh's first
    device, ``operands[p][q]`` the slab operands on the shards' devices
    (None: an empty block, skipped), ``mult(operand, xs, add_to)`` the
    slab multiply.  A shard's first multiply writes its result, every later
    one adds into it (in the ring order); a shard without any block holds
    zeros."""
    parts, cs, rows_pp = blocks.parts, blocks.col_shard, blocks.rows_pp
    home = devices[0]
    rmap = blocks.row_map.reshape(-1)
    pos = np.nonzero(rmap < blocks.n_rows)[0]
    if not np.array_equal(np.sort(rmap[pos]), np.arange(blocks.n_rows)):
        raise ValueError("shard slabs: a row is held by no slot or by several")
    inv = np.empty(blocks.n_rows, np.int64)
    inv[rmap[pos]] = pos
    inv = torch.from_numpy(inv).to(home)

    def step(y, p: int, q: int, xs):
        op = operands[p][q]
        return y if op is None else mult(op, xs, add_to=y)

    def shard_x(xp):
        return [xp[p * cs:(p + 1) * cs].to(devices[p], non_blocking=True)
                for p in range(parts)]

    if variant == "allgather":
        def shards(xp):
            return [step(None, p, 0, xp.to(devices[p], non_blocking=True))
                    for p in range(parts)]
    elif variant == "ring":
        def shards(xp):
            xs, y = shard_x(xp), [None] * parts
            for s in range(parts):
                for me in range(parts):
                    y[me] = step(y[me], me, (me + s) % parts, xs[me])
                if s < parts - 1:  # shard j's x block moves to shard j - 1
                    xs = [xs[(j + 1) % parts].to(devices[j], non_blocking=True)
                          for j in range(parts)]
            return y
    elif variant == "overlap":
        side = _SidePass()

        def send_all(xs):
            return [side.send(xs[(j + 1) % parts], devices[j]) for j in range(parts)]

        def shards(xp):
            xs, y = shard_x(xp), [None] * parts
            # the first pass is issued before the local column block's
            # multiply, so it is in flight while the shard does the only
            # work that needs no communication
            nxt = send_all(xs) if parts > 1 else None
            for me in range(parts):
                y[me] = step(None, me, me, xs[me])
            for s in range(1, parts):
                xs = [side.wait(t, ev) for t, ev in nxt]
                if s < parts - 1:
                    nxt = send_all(xs)
                for me in range(parts):
                    y[me] = step(y[me], me, (me + s) % parts, xs[me])
            return y
    else:
        raise ValueError(f"unknown variant {variant!r}")

    def run(x: torch.Tensor) -> torch.Tensor:
        xp = pad_x(x, parts * cs)
        tail = tuple(x.shape[1:])
        acc = acc_dtype(value_dtype, x.dtype)
        ys = [torch.zeros((rows_pp,) + tail, dtype=acc, device=home) if y is None
              else y.to(home, non_blocking=True) for y in shards(xp)]
        return torch.stack(ys).reshape((-1,) + tail).index_select(0, inv)

    return run


# ---------------------------------------------------------------------------
# traffic accounting (per-SpMV modelled byte movement)
# ---------------------------------------------------------------------------


def slab_traffic_bytes(blocks: ShardSlabs, variant: str, value_bytes: int = 4) -> dict:
    """Modelled bytes per SpMV: the matrix stream (every stored slot, the
    stacked padding included), the collective volume, and the peak per-shard
    x footprint (``overlap`` double-buffers: 2 shards)."""
    parts = blocks.parts
    idx_bytes = 4 * (2 if blocks.pack == "sell" else 1)  # col (+ rid) streams
    hbm = blocks.stored * (value_bytes + idx_bytes)
    collective = parts * (parts - 1) * blocks.col_shard * value_bytes
    x_shards = {"allgather": parts, "ring": 1, "overlap": min(2, parts)}[variant]
    per_chip_x = x_shards * blocks.col_shard * value_bytes
    return {"hbm_stream": hbm, "collective": collective, "per_chip_x": per_chip_x}


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclass
class DistributedSpMVPlan:
    """A compiled distributed SpMV / SpMM: partitioning, per-shard slab
    packing, format selection and the slab operands on the shards' devices
    are built once; ``plan(x)`` / ``plan.spmm(X)`` replay the executors.
    ``device`` is the mesh's first device: x comes in and y goes out
    there."""

    variant: str                    # "allgather" | "ring" | "overlap"
    parts: int
    axis: str
    slab_format: str                # committed slab pack
    balance: str                    # "nnz" | "rows"
    blocks: ShardSlabs
    shard_reports: tuple            # per-partition ShardReport
    run: object                     # f(x) -> y
    run_mm: object                  # f(X) -> Y
    traffic: dict                   # modelled per-SpMV byte movement
    slab_backend: str = "torch"     # registry entry of the slab multiplies
    mesh: Mesh | None = None
    operands: tuple = ()            # operands[p][q] on the shards' devices
    mults: dict = field(default_factory=dict)  # {"spmv" | "spmm": slab multiply}

    #: the SpMM runs once for all columns (never one SpMV a column)
    spmm_by_columns = False

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def __call__(self, x) -> torch.Tensor:
        return self.spmv(x)

    def _operand(self, x, what: str) -> torch.Tensor:
        return as_operand(x, self.device, what)

    def _fault_ctx(self, op: str) -> dict:
        return {"op": op, "variant": self.variant, "parts": self.parts,
                "backend": self.slab_backend, "kernel": self.variant}

    def spmv(self, x) -> torch.Tensor:
        """y = A @ x for x (N,) on the plan's device."""
        x = self._operand(x, "x")
        if tuple(x.shape) != (self.blocks.n_cols,):
            raise ValueError(f"x has shape {tuple(x.shape)}, expected ({self.blocks.n_cols},)")
        spec = faults.fire("dist.spmv", ctx=self._fault_ctx("spmv"))
        y = self.run(x)
        return faults.poison(y, spec) if spec is not None else y

    def spmm(self, X) -> torch.Tensor:
        """Y = A @ X for X (N, K): one distributed pass for all K columns, so
        the matrix stream and the x-shard exchange are paid once."""
        X = self._operand(X, "X")
        if X.dim() != 2 or X.shape[0] != self.blocks.n_cols:
            raise ValueError(f"X has shape {tuple(X.shape)}, expected "
                             f"({self.blocks.n_cols}, K)")
        spec = faults.fire("dist.spmm", ctx=self._fault_ctx("spmm"))
        Y = self.run_mm(X)
        return faults.poison(Y, spec) if spec is not None else Y

    @property
    def strategy(self) -> str:
        """Alias of ``variant`` (the pre-plan API name)."""
        return self.variant

    @property
    def imbalance(self) -> float:
        """max/mean stored nnz over shards (1.0 = perfect)."""
        stored = (self.blocks.val != 0).reshape(self.parts, -1).sum(axis=1)
        return float(stored.max() / max(1.0, stored.mean()))

    @property
    def local_fraction(self) -> float:
        """Fraction of nnz multiplied without communication."""
        tot = max(1, sum(r.nnz for r in self.shard_reports))
        return sum(r.local_nnz for r in self.shard_reports) / tot

    @property
    def report(self) -> PlanReport:
        """A ``PlanReport``-shaped summary (the straggler shard's predicted
        time), so consumers treat local and distributed plans alike."""
        t = max((r.times[self.slab_format] for r in self.shard_reports), default=1e-12)
        nnz = self.blocks.nnz
        flops = 2.0 * nnz
        bytes_streamed = self.traffic["hbm_stream"] + self.traffic["collective"]
        return PlanReport(format=f"dist-{self.slab_format}",
                          shape=(self.blocks.n_rows, self.blocks.n_cols), nnz=nnz,
                          kernel=self.variant, spmm_kernel=self.variant,
                          device=str(self.device),
                          balance_bytes_per_flop=bytes_streamed / max(1.0, flops),
                          predicted_gflops=flops / t / 1e9, predicted_time_s=t,
                          bound="memory")

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"DistributedSpMVPlan({self.variant}, parts={self.parts}, "
                f"slab={self.slab_format}, backend={self.slab_backend}, "
                f"imbalance={self.imbalance:.3f})")


def _as_csr(matrix) -> CSR:
    """Plans compile from CSR; a COO, ELL or SELL container is converted
    once (never through a dense intermediate) and the view cached on it."""
    if isinstance(matrix, CSR):
        return matrix
    cached = getattr(matrix, "_csr_view", None)
    if cached is None:
        if getattr(matrix, "scale", None) is not None:
            raise ValueError("distributed SpMV takes unquantized values; dequantize "
                             "the container first (formats.dequantize)")
        if isinstance(matrix, COO):
            cached = CSR.from_coo(matrix)
        elif isinstance(matrix, ELL):
            col, val = _np(matrix.col_idx), _np(matrix.val)
            rows = np.broadcast_to(np.arange(matrix.shape[0], dtype=np.int32)[:, None],
                                   val.shape)
            keep = val != 0
            cached = CSR.from_coo(COO(rows[keep], col[keep].astype(np.int32),
                                      matrix.val[torch.from_numpy(keep)], matrix.shape))
        elif isinstance(matrix, SELL):
            cached = CSR.from_coo(_sell_to_coo(matrix))
        else:
            raise TypeError(f"no distributed plan for {type(matrix).__name__}")
        object.__setattr__(matrix, "_csr_view", cached)
    return cached


def _sell_to_coo(s: SELL) -> COO:
    """SELL -> COO without densifying: the stored non-zeros of real rows, in
    storage order (chunk by chunk, slot by slot)."""
    cp, cw = _np(s.chunk_ptr), _np(s.chunk_width).astype(np.int64)
    col, val, perm = _np(s.col_idx), _np(s.val), _np(s.perm)
    chunk_of = np.repeat(np.arange(s.n_chunks), cw * s.C)
    rows = perm[chunk_of * s.C + (np.arange(col.shape[0]) - cp[chunk_of]) % s.C]
    keep = (val != 0) & (rows < s.shape[0])
    return COO(rows[keep].astype(np.int32), col[keep].astype(np.int32),
               s.val[torch.from_numpy(keep)], s.shape)


def _resolve_slab_backend(backend: str, devices: tuple) -> str:
    """The slab registry backend of a distributed ``backend=``: ``auto`` is
    ``cuda`` when every shard sits on a card (the registry's rule: a kernel
    that can run is taken), else ``torch``; ``torch`` / ``cuda`` /
    ``loop_reference`` pass (an explicit ``cuda`` off the card raises
    ``BackendUnavailable`` at compile)."""
    if backend == "auto":
        ok = all(R.probe_cuda(None, R.KernelContext(device=d)).ok for d in devices)
        return "cuda" if ok else "torch"
    if backend in R.BACKENDS:
        return backend
    raise ValueError(f"unknown backend {backend!r}; expected 'auto' or one of {R.BACKENDS}")


def compile_distributed_spmv_plan(m, mesh: Mesh | None = None, *, variant: str = "overlap",
                                  balance: str = "nnz", slab_format: str = "auto",
                                  axis: str = "data", C: int = 8, config=None,
                                  **plan_kw) -> DistributedSpMVPlan:
    """Partition ``m`` over the mesh and return a memoized distributed plan.

    ``m`` is CSR (COO / ELL / SELL go through a cached CSR view).
    ``mesh=None`` is every card (``make_mesh_1d``), or one shard on
    ``config.device`` when the config names one.  ``slab_format="auto"``
    lets the roofline choose per shard (``plan_shard_formats``) and commits
    to the fastest straggler; ``"ell"`` / ``"sell"`` force.  ``config`` (a
    ``PlanConfig``) carries ``chip``, ``am`` and ``backend`` (the slab
    backend, ``_resolve_slab_backend``); bare kwargs are deprecated aliases.
    The packer sorts each partition in full, so ``config.sigma`` does not
    apply.  Compiling twice with the same key returns the same object; each
    shard is packed once per key (``pack_stats``)."""
    from .planconfig import coerce_config

    cfg = coerce_config(config, plan_kw, api="compile_distributed_spmv_plan")
    chip, am = cfg.chip, cfg.am
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if mesh is None:
        mesh = make_mesh_1d(axis, device=cfg.device)
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    be = _resolve_slab_backend(cfg.backend, mesh.devices)
    m = _as_csr(m)
    if am is None:  # charge the stored value bytes
        am = PM.access_model_for(m, chip)
    parts = int(mesh.shape[axis])
    key = (variant, balance, slab_format, axis, parts, C, chip.name, am,
           tuple(str(d) for d in mesh.devices), be)
    cache = getattr(m, "_dist_plans", None)
    if cache is None:
        cache = {}
        object.__setattr__(m, "_dist_plans", cache)
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = _compile(m, mesh, variant, balance, slab_format, axis, C,
                                     chip, am, be)
    return plan


def _compile(m: CSR, mesh: Mesh, variant, balance, slab_format, axis, C, chip, am,
             backend: str) -> DistributedSpMVPlan:
    parts = int(mesh.shape[axis])
    bounds = partition_bounds(m, parts, balance)
    reports = plan_shard_formats(m, bounds, C=C, am=am, chip=chip)
    pack = select_slab_format(reports) if slab_format == "auto" else slab_format
    # ring and overlap share one packing and one set of operands (identical
    # layout); the slab cache lives beside the plan memo on the container
    cache = m._dist_plans
    local_cols = variant != "allgather"
    skey = ("slabs", balance, pack, local_cols, C, parts)
    blocks = cache.get(skey)
    if blocks is None:
        blocks = cache[skey] = pack_shard_slabs(m, parts, balance=balance, pack=pack,
                                                local_cols=local_cols, C=C, bounds=bounds)
    # built under every device of the mesh: the cuda probe refuses a host shard
    meta = SlabMeta(pack, blocks.rows_pp)
    mults = {op: [R.build(meta, f"slab_{pack}", op, backend,
                          R.KernelContext(device=d, chip=chip, am=am)).fn
                  for d in dict.fromkeys(mesh.devices)][0] for op in ("spmv", "spmm")}
    okey = ("operands", skey, backend, mesh.devices)
    operands = cache.get(okey)
    if operands is None:
        lens = block_lengths(m, blocks.bounds, local_cols) if backend == "cuda" else None
        operands = cache[okey] = slab_operands(blocks, lens, backend, mesh.devices, C,
                                               m.val.dtype)
    run = _make_executor(blocks, mesh.devices, variant, operands, mults["spmv"],
                         m.val.dtype)
    run_mm = _make_executor(blocks, mesh.devices, variant, operands, mults["spmm"],
                            m.val.dtype)
    traffic = slab_traffic_bytes(blocks, variant, m.val.element_size())
    return DistributedSpMVPlan(variant, parts, axis, pack, balance, blocks, tuple(reports),
                               run, run_mm, traffic, slab_backend=backend, mesh=mesh,
                               operands=operands, mults=mults)


def plan_all_variants(m, mesh: Mesh | None = None, **kw) -> dict:
    """All three variants over the same mesh (the distributed analogue of
    ``plan.plan_all_formats``)."""
    return {v: compile_distributed_spmv_plan(m, mesh, variant=v, **kw) for v in VARIANTS}
