"""The SELL SpMV kernel's chunk blocks and its walk, on the CPU.

``sell_chunk_blocks`` (the partition ``csrc/sell_spmv.cu`` runs on) is held
against a brute-force partition written independently here: blocks of
whole chunks within the budget of stored slots and rows, a chunk over it
alone, every chunk in exactly one block.  ``ChunkBlocks`` refuses chunks
that do not lie back to back, and the wrapper a partition it did not check
and an ``add_to`` it cannot take.  A numpy emulation of the kernel's walk
-- the partition's blocks, products staged per block and each row summed
in slot order, a lone chunk summed by groups of lanes and then across the
groups, the per-chunk scale, the inverse permutation at the store, and
``add_to`` -- is held against ``sell_spmv_plain`` and against the
reference's Pallas ``sell_spmv_arrays`` run in interpret mode followed by
``sell_spmv_scatter``, on identical containers: 1e-5 relative with an f32
accumulator, 1e-12 with f64 (the same products summed in another order).
"""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (  # noqa: E402
    VALUE_DTYPES, operand, ragged_csr_arrays, ref_matrix, ref_sell_spmv_pallas, rel_err,
    to_port, x64)
from repro.core import formats as RF  # noqa: E402
from repro.kernels import registry as RR  # noqa: E402
from repro_torch.core.formats import _np  # noqa: E402
from repro_torch.kernels import sell as KS  # noqa: E402
from repro_torch.kernels import sell_spmv as KP  # noqa: E402
from repro_torch.kernels.accum import acc_dtype  # noqa: E402
from repro_torch.kernels.cache import precompute_stats  # noqa: E402

THREADS = 256  # kBlock of the CUDA kernel

#: (matrix, C, sigma): sigma None is the row count; "ragged" has empty rows
#: (whole empty chunks at sigma 1), rows of thousands of nonzeros (chunks
#: over the budget) and, with C = 7, a ragged last chunk; C = 128 puts most
#: surrogate chunks over the budget, C = 300 is taller than a CUDA block
CONTAINERS = (("surrogate600", 8, 1), ("surrogate600", 8, 64), ("surrogate600", 8, None),
              ("powerlaw", 8, None), ("ragged", 7, 1), ("ragged", 7, 64),
              ("ragged", 7, None), ("surrogate600", 128, None), ("ragged", 300, None))
IDS = [f"{m}-C{c}-sigma{s}" for m, c, s in CONTAINERS]

_REF: dict = {}


def ref_sell(name: str, C: int, sigma, vd: str = "f64"):
    """Reference SELL container of a test matrix, f64 values then ``vd``."""
    key = (name, C, sigma)
    if key not in _REF:
        if name == "ragged":
            r = RF.CSR(*ragged_csr_arrays())
        else:
            r = ref_matrix(name)
            r = RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64), r.shape)
        _REF[key] = RF.SELL.from_csr(r, C=C, sigma=r.shape[0] if sigma is None else sigma)
    c = _REF[key]
    return c if vd == "f64" else RF.with_value_dtype(c, vd)


def brute_force_blocks(chunk_width, C: int) -> list:
    """Chunk by chunk: a chunk joins the open block while the block stays
    within the budget of slots and rows; a chunk alone over it is its own
    block."""
    budget = KP.SELL_BUDGET
    starts, slots, rows = [0], 0, 0
    for c, w in enumerate(int(v) for v in chunk_width):
        if rows and (slots + w * C > budget or rows + C > budget):
            starts.append(c)
            slots, rows = 0, 0
        slots, rows = slots + w * C, rows + C
    if len(chunk_width):
        starts.append(len(chunk_width))
    return starts


@pytest.mark.parametrize("name,C,sigma", CONTAINERS, ids=IDS)
def test_chunk_blocks_match_brute_force(name, C, sigma):
    budget = KP.SELL_BUDGET
    s = to_port(ref_sell(name, C, sigma))
    cp, cw = _np(s.chunk_ptr).astype(np.int64), _np(s.chunk_width).astype(np.int64)
    got = KP.sell_chunk_blocks(s.chunk_ptr, s.chunk_width, C)
    assert got.starts.dtype == torch.int32 and got.starts.device.type == "cpu"
    assert (got.n_chunks, got.C) == (s.n_chunks, C)
    assert got.n_blocks == got.starts.shape[0] - 1
    b = got.starts.numpy().astype(np.int64)
    assert b.tolist() == brute_force_blocks(cw, C)
    # every chunk in exactly one block, in order
    assert b[0] == 0 and b[-1] == s.n_chunks and (np.diff(b) >= 1).all()
    chunks, slots = np.diff(b), cp[b[1:]] - cp[b[:-1]]
    # each block's span is its chunks' slabs back to back
    assert np.array_equal(slots, np.add.reduceat(cw * C, b[:-1]) if b.size > 1 else slots)
    # within budget, but a chunk over it, which stands alone
    assert (((slots <= budget) & (chunks * C <= budget)) | (chunks == 1)).all()
    wide = np.nonzero((cw * C > budget) | (C > budget))[0]
    assert set(wide) <= set(b[:-1][chunks == 1])
    # the same partition from numpy operands, and built once per container
    assert torch.equal(KP.sell_chunk_blocks(cp, cw.astype(np.int32), C).starts, got.starts)
    before = precompute_stats()["sell_chunk_blocks"]
    assert KS.sell_chunk_blocks(s) is KS.sell_chunk_blocks(s)
    assert precompute_stats()["sell_chunk_blocks"] == before + 1
    assert torch.equal(KS.sell_chunk_blocks(s).starts, got.starts)


def test_chunk_blocks_of_no_chunks_and_of_empty_chunks():
    assert KP.sell_chunk_blocks(np.zeros(1, np.int64), np.zeros(0, np.int32), 8).n_blocks == 0
    # 1000 empty chunks of 8 rows: the row budget alone cuts them
    b = KP.sell_chunk_blocks(np.zeros(1001, np.int64), np.zeros(1000, np.int32), 8)
    k = KP.SELL_BUDGET // 8
    assert np.diff(b.starts.numpy()).tolist() == [k] * (1000 // k) + [1000 % k] * (1000 % k > 0)
    assert b.on("cpu") is b.on(torch.device("cpu"))


@pytest.mark.parametrize("cp,cw,C", (
    ([0, 8, 20], [1, 2], 8),        # a gap: chunk 1 starts past chunk 0's slab
    ([0, 8, 12], [1, 2], 8),        # an overlap: chunk 1's slab runs into chunk 2's
    ([4, 12], [1], 8),              # the first chunk not at slot 0
    ([0, 8], [1, 2], 8),            # chunk_ptr one short
    ([0, 7, 14], [1, 1], 8),        # slabs of another C
    ([0, 0], [0], 0),               # no rows a chunk
), ids=("gap", "overlap", "offset", "short", "other_C", "C0"))
def test_chunk_blocks_refuse_chunks_that_are_not_contiguous(cp, cw, C):
    with pytest.raises(ValueError, match="contiguous"):
        KP.ChunkBlocks(np.asarray(cp), np.asarray(cw), C)


def test_wrapper_refuses_a_partition_it_did_not_check():
    s = to_port(ref_sell("surrogate600", 8, 64))
    x = torch.ones(s.shape[1], dtype=torch.float64)
    n = s.shape[0]
    args = (s.chunk_ptr, s.chunk_width, s.col_idx, s.val, s.scale, s.perm, x, n, s.C)
    with pytest.raises(TypeError, match="ChunkBlocks"):
        KP.sell_spmv_arrays(*args, torch.tensor([0, 10], dtype=torch.int32))
    with pytest.raises(ValueError, match="chunks"):
        KP.sell_spmv_arrays(*args, KP.sell_chunk_blocks(s.chunk_ptr[:11], s.chunk_width[:10], 8))
    with pytest.raises(ValueError, match="chunks"):   # the partition of another C
        KP.sell_spmv_arrays(*args, KS.sell_chunk_blocks(to_port(ref_sell("surrogate600", 7, 64))))
    good = KP.sell_spmv_arrays(*args, KS.sell_chunk_blocks(s))
    assert torch.equal(good, KP.sell_spmv_arrays(*args))


def test_wrapper_refuses_an_add_to_it_cannot_take():
    s = to_port(ref_sell("surrogate600", 8, 64))
    x = torch.ones(s.shape[1], dtype=torch.float64)
    n = s.shape[0]
    args = (s.chunk_ptr, s.chunk_width, s.col_idx, s.val, s.scale, s.perm, x, n, s.C)
    with pytest.raises(TypeError, match="add_to"):   # not the accumulator type
        KP.sell_spmv_arrays(*args, add_to=torch.zeros(n, dtype=torch.float32))
    with pytest.raises(ValueError, match="add_to"):  # not contiguous
        KP.sell_spmv_arrays(*args, add_to=torch.zeros(2 * n, dtype=torch.float64)[::2])
    with pytest.raises(ValueError, match="add_to"):  # another length
        KP.sell_spmv_arrays(*args, add_to=torch.zeros(n + 1, dtype=torch.float64))


# --- the kernel's walk, emulated ---------------------------------------------------


def emulate_sell_spmv(s, x: torch.Tensor, add_to: np.ndarray | None = None) -> np.ndarray:
    """``csrc/sell_spmv.cu`` step by step in numpy: for each block of the
    partition, several chunks -- the span's products ``val * x[col]``
    staged, each row summed from them in slot order (``acc += p``, products
    and sums rounded separately) -- or one chunk alone -- ``256 // C``
    groups of C lanes, group g summing slots g, g + G, ..., then each lane
    summing its groups in order (a lane alone when C > 256) -- then the
    per-chunk scale and the store at the row's original position, added to
    ``add_to`` when given."""
    acc = acc_dtype(s.val.dtype, x.dtype)
    adt = np.float64 if acc == torch.float64 else np.float32
    cp, cw, col, perm = (_np(t).astype(np.int64) for t in
                         (s.chunk_ptr, s.chunk_width, s.col_idx, s.perm))
    val = s.val.to(acc).numpy()
    xa = x.to(acc).numpy()
    scale = np.ones(s.n_chunks, adt) if s.scale is None else _np(s.scale).astype(adt)
    n, C = s.shape[0], s.C
    y = np.full(n, np.nan, adt) if add_to is None else add_to.astype(adt).copy()
    written = np.zeros(n, bool)

    def store(c, sums):
        rows = perm[c * C:(c + 1) * C]
        real = rows < n
        sums = sums * scale[c]
        y[rows[real]] = (y[rows[real]] + sums[real]) if add_to is not None else sums[real]
        assert not written[rows[real]].any()
        written[rows[real]] = True

    starts = KP.sell_chunk_blocks(s.chunk_ptr, s.chunk_width, C).starts.numpy()
    for c0, c1 in zip(starts[:-1].tolist(), starts[1:].tolist()):
        s0 = cp[c0]
        if c1 - c0 == 1:   # one chunk alone, of any width
            w = int(cw[c0])
            slab_v = val[s0:s0 + w * C].reshape(w, C)
            slab_x = xa[col[s0:s0 + w * C]].reshape(w, C)
            prods = slab_v * slab_x
            G = THREADS // C if C <= THREADS else 1
            tot = np.zeros(C, adt)
            for g in range(G):
                part = np.zeros(C, adt)
                for j in range(g, w, G):
                    part = part + prods[j]
                tot = tot + part
            store(c0, tot)
            continue
        prod = val[s0:cp[c1]] * xa[col[s0:cp[c1]]]   # staged in shared memory
        for c in range(c0, c1):
            a = np.zeros(C, adt)
            for j in range(int(cw[c])):
                a = a + prod[cp[c] - s0 + j * C: cp[c] - s0 + (j + 1) * C]
            store(c, a)
    assert written.all(), "a row of y was never written"
    return y


@pytest.mark.parametrize("add", (False, True), ids=("store", "add_to"))
@pytest.mark.parametrize("vd", VALUE_DTYPES)
@pytest.mark.parametrize("name,C,sigma", CONTAINERS, ids=IDS)
def test_kernel_walk_matches_plain(name, C, sigma, vd, add):
    s = to_port(ref_sell(name, C, sigma, vd))
    dt = torch.float64 if vd == "f64" else torch.float32
    x = torch.from_numpy(operand(s.shape[1], seed=3, dtype=np.float64)).to(dt)
    acc = acc_dtype(s.val.dtype, dt)
    base = torch.from_numpy(operand(s.shape[0], seed=4, dtype=np.float64)).to(acc)
    got = emulate_sell_spmv(s, x, base.numpy() if add else None)
    into = base.clone() if add else None
    want = KP.sell_spmv_plain(s.chunk_ptr, s.chunk_width, s.col_idx, s.val, s.scale, s.perm,
                              x, s.shape[0], C, add_to=into)
    assert want is into if add else want is not base
    want = want.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert rel_err(got, want) <= (1e-12 if want.dtype == np.float64 else 1e-5)


@pytest.mark.parametrize("vd", ("f64", "f32", "int8"))
@pytest.mark.parametrize("name,C,sigma", CONTAINERS, ids=IDS)
def test_kernel_walk_matches_reference_pallas(name, C, sigma, vd):
    ref_c = ref_sell(name, C, sigma, vd)
    s = to_port(ref_c)
    dt = np.float64 if vd == "f64" else np.float32
    x = operand(s.shape[1], seed=31, dtype=dt)
    with x64(vd == "f64"):
        want = ref_sell_spmv_pallas(ref_c, x)
    got = emulate_sell_spmv(s, torch.from_numpy(x))
    assert got.dtype == want.dtype
    assert rel_err(got, want) <= (1e-12 if dt == np.float64 else 1e-5)


@pytest.mark.parametrize("vd", ("f32", "bf16", "int8"))
def test_hybrid_add_to_matches_the_reference_composition(vd):
    # the hybrid plan's SELL kernel adds into the DIA output: the same sum
    # as the reference's Pallas hybrid, DIA output plus SELL output
    r = ref_matrix("surrogate600")
    ref_h = RF.with_value_dtype(RF.split_dia(RF.CSR(r.row_ptr, r.col_idx, np.asarray(
        r.val, np.float64), r.shape)), vd)
    h = to_port(ref_h)
    x = jnp.asarray(operand(h.shape[1], seed=5))
    # (the reference's Pallas entries take no f64 values)
    want = np.asarray(RR.build(ref_h, "hybrid", "spmv", "pallas_interpret").fn(x))
    dia_out = np.asarray(RR.build(ref_h.dia, "dia", "spmv", "pallas_interpret").fn(x))
    got = emulate_sell_spmv(h.rest, torch.from_numpy(np.array(x)), dia_out)
    assert got.dtype == want.dtype == np.float32
    assert rel_err(got, want) <= 1e-5


def test_ablation_edits_apply_to_the_kernel_source():
    # the ablation (repro_torch.testing.sell_ablation, run on the card) takes
    # suspects out of csrc/sell_spmv.cu by text edits: each must still apply
    from repro_torch.kernels import cuda_build as CB
    from repro_torch.testing import sell_ablation as SA
    variants = SA._variants(CB.source_path("sell_spmv").read_text())
    assert [v[0] for v in variants][:3] == ["kernel", "coalesced_x", "slot_order"]
    for name, src, edits, checked in variants:
        assert checked == (name in ("kernel", "first_design", "first_design_loads_ahead"))
        for old, new in edits:
            assert src.count(old) >= 1 and old != new, name

