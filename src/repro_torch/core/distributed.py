"""Partitioners, the mesh, and the legacy distributed SpMV primitives (the
paper's section 5 base layer).

Port of ``repro.core.distributed``.  The distributed stack is layered:

1. **This module -- partitioning, the mesh and raw primitives.**  Row cuts
   (``row_balanced_partition`` = OpenMP ``schedule(static)`` on rows,
   ``nnz_balanced_partition`` = static scheduling balanced on work while
   preserving locality, the paper's winning recipe), the uniform-ELL
   executors ``make_allgather_spmv`` / ``make_ring_spmv`` over
   ``RowBlockELL`` / ``RingBlockELL`` (the paper-fidelity baseline), and
   the per-SpMV traffic models.
2. **``core.distributed_plan`` -- the compiled plan layer**: per-shard slab
   packing, the perfmodel's slab-format choice and the three executor
   variants (allgather, ring, overlap) in SpMV and SpMM form.
3. **Consumers**: ``eigensolver.lanczos(mesh=)`` and
   ``serve.BatchingSpMVServer.register_distributed``.

The mesh is single-controller, as the reference's is: one process holds a
1-D tuple of ``torch.device``s and ``plan(x)`` takes the whole x and returns
the whole y.  A device may repeat -- P shards on one card are the
counterpart of the reference's emulated host mesh -- and on a box with
several cards the shards sit on distinct cards.  Moving an x shard to the
next shard's device is ``tensor.to(device)``: a no-op on the same device,
so one code path serves one card and several.

The packers are vectorized numpy (one stable sort by (row, column block),
bincounts and one scatter), producing bitwise the arrays of the reference's
per-row loops.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .formats import CSR, _np

# ---------------------------------------------------------------------------
# partitioning (paper section 5.2: scheduling / load balance)
# ---------------------------------------------------------------------------


def row_balanced_partition(n_rows: int, parts: int) -> np.ndarray:
    """Equal row counts (OpenMP ``schedule(static)`` on rows)."""
    return np.linspace(0, n_rows, parts + 1).round().astype(np.int64)


def nnz_balanced_partition(m: CSR, parts: int) -> np.ndarray:
    """Cut rows so each part carries ~nnz/parts non-zeros, each cut on the
    row boundary nearest the ideal split point.  Never worse than
    ``row_balanced_partition``: if the greedy cut loses on a degenerate
    pattern, the row-balanced bounds are returned instead."""
    rp = _np(m.row_ptr).astype(np.int64)
    total = rp[-1]
    targets = np.arange(1, parts, dtype=np.float64) * (total / parts)
    cuts = np.searchsorted(rp, targets, side="left")
    cuts = np.clip(cuts, 1, m.n_rows)
    lo = np.abs(rp[cuts - 1] - targets)
    hi = np.abs(rp[np.minimum(cuts, m.n_rows)] - targets)
    cuts = np.where(lo < hi, cuts - 1, cuts)
    bounds = np.concatenate([[0], cuts, [m.n_rows]]).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)  # monotone on degenerate rows
    by_rows = row_balanced_partition(m.n_rows, parts)
    if partition_imbalance(m, by_rows) < partition_imbalance(m, bounds):
        return by_rows
    return bounds


def partition_imbalance(m: CSR, bounds: np.ndarray) -> float:
    """max part nnz / mean part nnz -- 1.0 is perfect."""
    rp = _np(m.row_ptr).astype(np.int64)
    nnz = rp[bounds[1:]] - rp[bounds[:-1]]
    return float(nnz.max() / max(1.0, nnz.mean()))


def partition_bounds(m: CSR, parts: int, balance: str) -> np.ndarray:
    """The bounds of ``balance`` ("nnz" or anything else: rows)."""
    return (nnz_balanced_partition(m, parts) if balance == "nnz"
            else row_balanced_partition(m.n_rows, parts))


# ---------------------------------------------------------------------------
# the vectorized block layout shared by every packer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockEntries:
    """Every stored entry of a row-partitioned matrix, placed in its block.

    Rows are cut by ``bounds`` into P parts of at most ``rows_pp`` rows;
    with ``Q == parts`` the columns are cut into Q blocks of ``col_shard``
    and each entry's column is local to its block (``Q == 1``: global
    columns).  Entries are ordered by (row, q), CSR order within, so
    ``slot`` (an entry's position among its row's entries in block q) is
    the reference packers' fill position.  ``lens`` (P, Q, rows_pp) counts
    the entries of each (part, block, local row)."""

    part: np.ndarray      # (nnz,) int64 part of the entry's row
    local_row: np.ndarray  # (nnz,) int64 row within the part
    q: np.ndarray         # (nnz,) int64 column block
    slot: np.ndarray      # (nnz,) int64 position within its (row, q) piece
    col: np.ndarray       # (nnz,) int32 column (block-local when Q > 1)
    val: np.ndarray       # (nnz,) values, the container's numpy dtype
    lens: np.ndarray      # (P, Q, rows_pp) int64
    bounds: np.ndarray
    rows_pp: int
    col_shard: int


def _require_unquantized(m: CSR) -> None:
    if m.scale is not None:
        raise ValueError("distributed SpMV takes unquantized values; dequantize "
                         "the container first (formats.dequantize)")


def block_entries(m: CSR, bounds: np.ndarray, local_cols: bool) -> BlockEntries:
    """Place ``m``'s entries into the (part, column block) grid of ``bounds``."""
    _require_unquantized(m)
    bounds = np.asarray(bounds, dtype=np.int64)
    parts = len(bounds) - 1
    n = m.n_rows
    rows_pp = int(max(1, (bounds[1:] - bounds[:-1]).max()))
    cs = -(-m.shape[1] // parts)
    Q = parts if local_cols else 1
    rp = _np(m.row_ptr).astype(np.int64)
    ci, v = _np(m.col_idx), _np(m.val)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    if Q > 1:
        q = ci.astype(np.int64) // cs
        key = rows * Q + q
        order = np.argsort(key, kind="stable")
        rows, q, key, ci, v = rows[order], q[order], key[order], ci[order], v[order]
        col = (ci - q * cs).astype(np.int32)
    else:
        q = np.zeros(rows.shape[0], np.int64)
        key = rows
        col = ci.astype(np.int32)
    cnt = np.bincount(key, minlength=n * Q).astype(np.int64)
    slot = np.arange(key.shape[0], dtype=np.int64) - (np.cumsum(cnt) - cnt)[key]
    part_of, local_of = _row_places(bounds, n)
    return BlockEntries(part_of[rows], local_of[rows], q, slot, col, v,
                        _lens_grid(cnt, bounds, Q, rows_pp), bounds, rows_pp, cs)


def _row_places(bounds: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(part, row within the part) of every row."""
    part_of = np.searchsorted(bounds, np.arange(n), side="right") - 1
    return part_of, np.arange(n, dtype=np.int64) - bounds[part_of]


def _lens_grid(cnt: np.ndarray, bounds: np.ndarray, Q: int, rows_pp: int) -> np.ndarray:
    """(n * Q,) per-(row, q) counts as the (P, Q, rows_pp) grid (pads 0)."""
    n = cnt.shape[0] // Q
    part_of, local_of = _row_places(bounds, n)
    lens = np.zeros((len(bounds) - 1, Q, rows_pp), np.int64)
    lens[np.repeat(part_of, Q), np.tile(np.arange(Q), n), np.repeat(local_of, Q)] = cnt
    return lens


def block_lengths(m: CSR, bounds: np.ndarray, local_cols: bool) -> np.ndarray:
    """The ``lens`` grid of :func:`block_entries` alone (one bincount)."""
    bounds = np.asarray(bounds, dtype=np.int64)
    parts = len(bounds) - 1
    Q = parts if local_cols else 1
    rows_pp = int(max(1, (bounds[1:] - bounds[:-1]).max()))
    rp = _np(m.row_ptr).astype(np.int64)
    key = np.repeat(np.arange(m.n_rows, dtype=np.int64), np.diff(rp)) * Q
    if Q > 1:
        key += _np(m.col_idx).astype(np.int64) // -(-m.shape[1] // parts)
    return _lens_grid(np.bincount(key, minlength=m.n_rows * Q).astype(np.int64),
                      bounds, Q, rows_pp)


def row_map_of(bounds: np.ndarray, rows_pp: int, n_rows: int) -> np.ndarray:
    """(P, rows_pp) global row of each slab row (pad rows -> ``n_rows``)."""
    parts = len(bounds) - 1
    rmap = np.full((parts, rows_pp), n_rows, dtype=np.int32)
    for p in range(parts):
        r0, r1 = int(bounds[p]), int(bounds[p + 1])
        rmap[p, : r1 - r0] = np.arange(r0, r1, dtype=np.int32)
    return rmap


def ell_pack(e: BlockEntries, W: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(P, Q, rows_pp, W) col / val: each row's entries from slot 0, zeros
    after (``W`` defaults to the longest piece, at least 1)."""
    P, Q, rows_pp = e.lens.shape
    if W is None:
        W = int(max(1, e.lens.max(initial=0)))
    col = np.zeros(P * Q * rows_pp * W, dtype=np.int32)
    val = np.zeros(P * Q * rows_pp * W, dtype=e.val.dtype)
    dest = ((e.part * Q + e.q) * rows_pp + e.local_row) * W + e.slot
    col[dest] = e.col
    val[dest] = e.val
    return col.reshape(P, Q, rows_pp, W), val.reshape(P, Q, rows_pp, W)


def sell_layout(lens: np.ndarray, C: int):
    """The chunks of the flat SELL-C pack of every (part, block) of ``lens``
    (P, Q, rows_pp): its rows sorted by descending length (stable: the full
    per-partition JDS sort), cut into ``nc = ceil(rows_pp / C)`` chunks of
    C, each as wide as its first (longest) row.  Returns ``order`` (P, Q,
    rows_pp) the row at each sorted position, ``widths`` and ``offsets``
    (P, Q, nc) each chunk's width and start in the block's flat array, and
    ``total`` (P, Q) the block's flat length.  Pad rows (length 0) sort
    after every real row, so the chunks of the real rows are the
    reference's and a chunk of zero width stores nothing: the reference's
    skipped all-empty chunks."""
    P, Q, rows_pp = lens.shape
    nc = -(-rows_pp // C)
    order = np.argsort(-lens, axis=-1, kind="stable")
    slens = np.zeros((P, Q, nc * C), np.int64)
    slens[..., :rows_pp] = np.take_along_axis(lens, order, -1)
    widths = slens.reshape(P, Q, nc, C)[..., 0]
    sizes = widths * C
    offsets = np.cumsum(sizes, axis=-1) - sizes
    return order, widths, offsets, sizes.sum(axis=-1)


def sell_pack(e: BlockEntries, C: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(P, Q, L) col / val / rid of the flat SELL-C pack: chunk-column-major
    ``(width, C)`` slabs back to back, every block padded to the longest
    block's length ``L``; ``rid`` holds partition-local rows (pad ->
    rows_pp)."""
    P, Q, rows_pp = e.lens.shape
    order, widths, offsets, total = sell_layout(e.lens, C)
    L = int(max(1, total.max(initial=0)))
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(rows_pp), order.shape), -1)
    b = e.part * Q + e.q
    r = rank.reshape(P * Q, rows_pp)[b, e.local_row]
    dest = b * L + offsets.reshape(P * Q, -1)[b, r // C] + e.slot * C + r % C
    col = np.zeros(P * Q * L, dtype=np.int32)
    val = np.zeros(P * Q * L, dtype=e.val.dtype)
    rid = np.full(P * Q * L, rows_pp, dtype=np.int32)
    col[dest] = e.col
    val[dest] = e.val
    rid[dest] = e.local_row
    return col.reshape(P, Q, L), val.reshape(P, Q, L), rid.reshape(P, Q, L)


# ---------------------------------------------------------------------------
# host block containers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RowBlockELL:
    """Row-partitioned matrix as P stacked uniform ELL slabs.

    col/val: (P, rows_pp, W); row_map: (P, rows_pp) global row id (pad ->
    n); x is padded to P * x_shard."""

    col: np.ndarray
    val: np.ndarray
    row_map: np.ndarray
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def parts(self) -> int:
        return int(self.col.shape[0])


def build_row_blocks(m: CSR, parts: int, balance: str = "nnz",
                     pad_width_to: int = 1) -> RowBlockELL:
    bounds = partition_bounds(m, parts, balance)
    e = block_entries(m, bounds, local_cols=False)
    lens = m.row_lengths()
    W = int(max(1, lens.max())) if lens.size else 1
    W = -(-W // pad_width_to) * pad_width_to
    col, val = ell_pack(e, W)
    return RowBlockELL(col[:, 0], val[:, 0], row_map_of(bounds, e.rows_pp, m.n_rows),
                       m.n_rows, m.shape[1], m.nnz)


@dataclass(frozen=True)
class RingBlockELL:
    """Row x column partitioned matrix for the ring (overlap) SpMV.

    col/val: (P, Q, rows_pp, W) with column indices local to block q."""

    col: np.ndarray
    val: np.ndarray
    row_map: np.ndarray  # (P, rows_pp)
    col_shard: int       # columns per shard (padded)
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def parts(self) -> int:
        return int(self.col.shape[0])


def build_ring_blocks(m: CSR, parts: int, balance: str = "nnz") -> RingBlockELL:
    bounds = partition_bounds(m, parts, balance)
    e = block_entries(m, bounds, local_cols=True)
    col, val = ell_pack(e)
    return RingBlockELL(col, val, row_map_of(bounds, e.rows_pp, m.n_rows),
                        e.col_shard, m.n_rows, m.shape[1], m.nnz)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices of the shards, in shard order (a device may
    repeat), under one axis name."""

    devices: tuple
    axis_names: tuple = ("data",)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs or len(self.axis_names) != 1:
            raise ValueError("a mesh needs at least one device and exactly one axis")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}


def make_mesh_1d(axis: str = "data", n_devices: int | None = None,
                 device=None) -> Mesh:
    """A 1-D mesh over ``axis``.

    ``device=None``: the first ``n_devices`` visible cards (default: every
    card); a ``RuntimeError`` without one, and a ``ValueError`` for more
    shards than cards.  An explicit ``device`` (``"cpu"``, ``"cuda:0"``)
    places ``n_devices`` shards (default 1) on that one device."""
    from ..utils.hw import default_device

    if device is not None:
        dev = default_device(device)
        return Mesh((dev,) * int(n_devices or 1), (axis,))
    default_device(None)  # raises without a card
    count = torch.cuda.device_count()
    nd = count if n_devices is None else int(n_devices)
    if not 1 <= nd <= count:
        raise ValueError(f"{nd} shards on {count} visible card(s): pass device= "
                         "to place several shards on one device")
    return Mesh(tuple(torch.device("cuda", i) for i in range(nd)), (axis,))


# ---------------------------------------------------------------------------
# the legacy uniform-ELL executors
# ---------------------------------------------------------------------------


def pad_x(x: torch.Tensor, length: int) -> torch.Tensor:
    """``x`` (n[, K]) zero-padded to ``length`` rows (a fresh tensor)."""
    xp = x.new_zeros((length,) + tuple(x.shape[1:]))
    xp[: x.shape[0]] = x
    return xp


def _check_mesh(parts: int, mesh: Mesh, axis: str) -> tuple:
    if mesh.shape.get(axis) != parts:
        raise ValueError(f"{parts} slabs on a mesh of {mesh.shape}")
    return mesh.devices


def _scatter_rows(yparts, rmap, n: int) -> torch.Tensor:
    out = yparts[0].new_zeros(n + 1)
    return out.index_add_(0, rmap.reshape(-1), torch.cat(yparts))[:n]


def make_allgather_spmv(blocks: RowBlockELL, mesh: Mesh, axis: str = "data"):
    """y = A @ x with x all-gathered once per SpMV: each shard sees the whole
    (padded) x, runs its uniform ELL slab, and the row-block results are
    scattered back.  Returns ``run(x) -> y`` (x and y on the mesh's first
    device)."""
    devs = _check_mesh(blocks.parts, mesh, axis)
    parts = blocks.parts
    col = [torch.from_numpy(blocks.col[p]).to(devs[p]) for p in range(parts)]
    val = [torch.from_numpy(blocks.val[p]).to(devs[p]) for p in range(parts)]
    rmap = torch.from_numpy(blocks.row_map.astype(np.int64)).to(devs[0])
    shard = -(-blocks.n_cols // parts)

    def run(x: torch.Tensor) -> torch.Tensor:
        xp = pad_x(x, parts * shard)
        yparts = [(val[p] * xp.to(devs[p])[col[p]]).sum(dim=1).to(devs[0])
                  for p in range(parts)]
        return _scatter_rows(yparts, rmap, blocks.n_rows)

    return run


def make_ring_spmv(blocks: RingBlockELL, mesh: Mesh, axis: str = "data"):
    """Ring SpMV: P steps of (multiply the column block of the x shard held)
    + (pass that shard to the previous shard's device); the full x never
    sits on one shard.  Returns ``run(x) -> y``."""
    devs = _check_mesh(blocks.parts, mesh, axis)
    parts, cs = blocks.parts, blocks.col_shard
    col = [torch.from_numpy(blocks.col[p]).to(devs[p]) for p in range(parts)]
    val = [torch.from_numpy(blocks.val[p]).to(devs[p]) for p in range(parts)]
    rmap = torch.from_numpy(blocks.row_map.astype(np.int64)).to(devs[0])

    def run(x: torch.Tensor) -> torch.Tensor:
        xp = pad_x(x, parts * cs)
        xs = [xp[p * cs:(p + 1) * cs].to(devs[p]) for p in range(parts)]
        y = [None] * parts
        for s in range(parts):
            for me in range(parts):
                src = (me + s) % parts
                contrib = (val[me][src] * xs[me][col[me][src]]).sum(dim=1)
                y[me] = contrib if y[me] is None else y[me] + contrib
            if s < parts - 1:  # shard j's x block moves to shard j - 1
                xs = [xs[(j + 1) % parts].to(devs[j]) for j in range(parts)]
        return _scatter_rows([t.to(devs[0]) for t in y], rmap, blocks.n_rows)

    return run


# ---------------------------------------------------------------------------
# distributed execution plans -- in core.distributed_plan
# ---------------------------------------------------------------------------


def compile_distributed_plan(m, mesh: Mesh | None = None, *, strategy: str = "allgather",
                             balance: str = "nnz", axis: str = "data", **kw):
    """Back-compat entry point: ``distributed_plan.compile_distributed_spmv_plan``
    with ``strategy`` as its ``variant``."""
    from .distributed_plan import compile_distributed_spmv_plan

    return compile_distributed_spmv_plan(m, mesh, variant=strategy,
                                         balance=balance, axis=axis, **kw)


# ---------------------------------------------------------------------------
# traffic accounting (for the parallel benchmarks / roofline)
# ---------------------------------------------------------------------------


def allgather_traffic_bytes(blocks: RowBlockELL, value_bytes: int = 4) -> dict:
    parts = blocks.parts
    shard = -(-blocks.n_cols // parts)
    stored = int(np.prod(blocks.col.shape))
    return {
        "hbm_stream": stored * (value_bytes + 4),
        "collective": parts * shard * value_bytes * (parts - 1),  # ring allgather
        "per_chip_x": parts * shard * value_bytes,                # gathered copy
    }


def ring_traffic_bytes(blocks: RingBlockELL, value_bytes: int = 4) -> dict:
    parts = blocks.parts
    stored = int(np.prod(blocks.col.shape[1:]))  # per shard
    return {
        "hbm_stream": parts * stored * (value_bytes + 4),
        "collective": parts * blocks.col_shard * value_bytes * (parts - 1),
        "per_chip_x": blocks.col_shard * value_bytes,             # 1 shard only
    }


# ---------------------------------------------------------------------------
# selftest: python -m repro_torch.core.distributed [n] --parts P --device D
# ---------------------------------------------------------------------------


def _selftest(argv=None) -> int:
    import argparse

    from .distributed_plan import VARIANTS, compile_distributed_spmv_plan
    from .matrices import holstein_hubbard_surrogate

    ap = argparse.ArgumentParser(description="distributed SpMV selftest")
    ap.add_argument("n", type=int, nargs="?", default=4000)
    ap.add_argument("--parts", type=int, default=None,
                    help="shards (default: every card, or 8 with --device)")
    ap.add_argument("--device", default=None,
                    help="place every shard on this device (default: one a card)")
    args = ap.parse_args(argv)
    n = args.n
    m = holstein_hubbard_surrogate(n, seed=3)
    parts = args.parts if args.parts is not None or args.device is None else 8
    mesh = make_mesh_1d(n_devices=parts, device=args.device)
    parts = len(mesh.devices)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    x = x.to(mesh.devices[0])
    rp, ci, v = (_np(a) for a in (m.row_ptr, m.col_idx, m.val))
    rows = np.repeat(np.arange(n), np.diff(rp))
    y_ref = np.bincount(rows, weights=v.astype(np.float64) * x.cpu().numpy()[ci],
                        minlength=n)

    def err(y) -> float:
        return float(np.max(np.abs(y.cpu().numpy() - y_ref)) / max(1e-9, np.max(np.abs(y_ref))))

    ok = True
    for name, build, make in (("allgather-legacy", build_row_blocks, make_allgather_spmv),
                              ("ring-legacy", build_ring_blocks, make_ring_spmv)):
        e = err(make(build(m, parts), mesh)(x))
        ok &= e < 1e-4
        print(f"{name}: shards={parts} rel_err={e:.2e} {'OK' if e < 1e-4 else 'FAIL'}")
    for variant in VARIANTS:
        plan = compile_distributed_spmv_plan(m, mesh, variant=variant)
        e = err(plan(x))
        ok &= e < 1e-4
        print(f"{variant}: shards={parts} slab={plan.slab_format} backend="
              f"{plan.slab_backend} local={plan.local_fraction:.2f} rel_err={e:.2e} "
              f"{'OK' if e < 1e-4 else 'FAIL'}")
    imb_rows = partition_imbalance(m, row_balanced_partition(m.n_rows, parts))
    imb_nnz = partition_imbalance(m, nnz_balanced_partition(m, parts))
    print(f"imbalance rows={imb_rows:.3f} nnz={imb_nnz:.3f}")
    print("SELFTEST PASS" if ok else "SELFTEST FAIL")
    return 0 if ok else 1


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess test
    import sys

    sys.exit(_selftest())
