"""The CSR kernel's row-block partition and its reduction, on the CPU.

``csr_row_blocks`` is held against a brute-force partition written
independently here, on the corpus matrices and on a matrix with empty rows
and rows longer than the budget.  A torch / numpy emulation of the CUDA
kernel's block-span reduction (``csrc/csr_spmv.cu``: products staged per
block, rows summed by L lanes with a shuffle tree, one-row blocks summed by
256 threads and 8 warps), driven by that partition, is held against
``csr_spmv_plain`` and the reference's ``xla`` entry on the identical
container: 1e-5 relative with an f32 accumulator, 1e-12 with f64 (the same
products summed in another order).
"""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (  # noqa: E402
    operand, ragged_csr_arrays, ref_apply, ref_matrix, rel_err, to_port, x64)
from repro.core import formats as RF  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.kernels import csr as PCSR  # noqa: E402
from repro_torch.kernels import csr_spmv as KP  # noqa: E402
from repro_torch.kernels.accum import acc_dtype  # noqa: E402
from repro_torch.kernels.cache import precompute_stats  # noqa: E402

THREADS = 256  # kBlock of the CUDA kernel

MATRICES = ("surrogate600", "surrogate3000", "exact3", "laplace24", "powerlaw",
            "blocksparse", "ragged")


def ref_csr(name: str):
    if name == "ragged":
        return RF.CSR(*ragged_csr_arrays())
    r = ref_matrix(name)
    return RF.CSR(r.row_ptr, r.col_idx, np.asarray(r.val, np.float64), r.shape)


def brute_force_blocks(row_ptr) -> list:
    """Row by row: a row joins the open block while the block stays within
    the budget of nonzeros and rows; a row alone over it is its own block."""
    budget = KP.CSR_BUDGET
    lens = np.diff(np.asarray(row_ptr, np.int64))
    starts, nnz, rows = [0], 0, 0
    for r, k in enumerate(lens):
        if rows and (nnz + k > budget or rows + 1 > budget):
            starts.append(r)
            nnz, rows = 0, 0
        nnz, rows = nnz + int(k), rows + 1
    if len(lens):
        starts.append(len(lens))
    return starts


@pytest.mark.parametrize("name", MATRICES)
def test_csr_row_blocks_matches_brute_force(name):
    budget = KP.CSR_BUDGET
    rp = np.asarray(ref_csr(name).row_ptr, np.int64)
    got = KP.csr_row_blocks(rp)
    assert got.starts.dtype == torch.int32 and got.starts.device.type == "cpu"
    assert got.n_rows == rp.shape[0] - 1 and got.n_blocks == got.starts.shape[0] - 1
    b = got.starts.numpy().astype(np.int64)
    assert b.tolist() == brute_force_blocks(rp)
    # every row in exactly one block, in order, empty rows kept
    assert b[0] == 0 and b[-1] == rp.shape[0] - 1 and (np.diff(b) >= 1).all()
    nnz = rp[b[1:]] - rp[b[:-1]]
    rows = np.diff(b)
    # within budget, but a longer row, which stands alone
    assert ((nnz <= budget) | (rows == 1)).all() and (rows <= budget).all()
    long_rows = np.nonzero(np.diff(rp) > budget)[0]
    assert set(long_rows) <= set(b[:-1][rows == 1])
    # the same partition from a torch row_ptr
    assert torch.equal(KP.csr_row_blocks(torch.from_numpy(rp.astype(np.int32))).starts,
                       got.starts)


def test_csr_row_blocks_of_an_empty_matrix_and_one_empty_row():
    assert KP.csr_row_blocks(np.zeros(1, np.int32)).starts.tolist() == [0]
    assert KP.csr_row_blocks(np.zeros(2, np.int32)).starts.tolist() == [0, 1]
    # a run of empty rows is cut at the row cap
    assert KP.csr_row_blocks(np.zeros(2501, np.int32)).starts.tolist() == \
        [0, 1024, 2048, 2500]


def test_csr_row_blocks_refuse_a_row_ptr_that_decreases():
    with pytest.raises(ValueError, match="nondecreasing"):
        KP.csr_row_blocks(np.array([0, 5, 3, 8], np.int32))


def test_row_blocks_reach_a_device_once():
    b = KP.csr_row_blocks(ragged_csr_arrays()[0])
    assert b.on("cpu") is b.on(torch.device("cpu"))
    assert torch.equal(b.on("cpu"), b.starts)


def test_wrapper_refuses_a_partition_it_did_not_check():
    c = to_port(ref_csr("ragged"))
    x = torch.from_numpy(operand(c.shape[1], seed=32, dtype=np.float64))
    # a partition with a gap: rows 10.. in no block
    with pytest.raises(TypeError, match="RowBlocks"):
        KP.csr_spmv_arrays(c.row_ptr, c.col_idx, c.val, c.scale, x,
                           torch.tensor([0, 10], dtype=torch.int32))
    with pytest.raises(ValueError, match="rows"):
        KP.csr_spmv_arrays(c.row_ptr, c.col_idx, c.val, c.scale, x,
                           KP.csr_row_blocks(c.row_ptr[:11]))


def test_plan_caches_the_row_blocks_once():
    m = to_port(ref_csr("surrogate600"))
    before = precompute_stats()["csr_row_blocks"]
    b1, b2 = PCSR.csr_row_blocks(m), PCSR.csr_row_blocks(m)
    assert b1 is b2 and precompute_stats()["csr_row_blocks"] == before + 1
    assert isinstance(b1, KP.RowBlocks)
    assert torch.equal(b1.starts, KP.csr_row_blocks(m.row_ptr).starts)


# --- the kernel's reduction, emulated -----------------------------------------


def _tree(vals: np.ndarray, width: int) -> np.ndarray:
    """__shfl_down_sync tree over groups of ``width`` lanes: every lane
    reads its partner's value from before the step."""
    v = vals.copy()
    off = width // 2
    while off:
        nxt = v.copy()
        g = v.reshape(-1, width)
        nxt.reshape(-1, width)[:, :width - off] = g[:, :width - off] + g[:, off:]
        v = nxt
        off //= 2
    return v


def emulate_row_blocks(row_ptr, col, val, scale, x, blocks):
    """The CUDA kernel's arithmetic, in its order, on the host."""
    acc = acc_dtype(val.dtype, x.dtype)
    ndt = np.float64 if acc == torch.float64 else np.float32
    rp = row_ptr.numpy().astype(np.int64)
    prod = (val.to(acc) * x.to(acc)[col.long()]).numpy()
    y = np.zeros(rp.shape[0] - 1, ndt)
    b = blocks.starts.numpy()
    for r0, r1 in zip(b[:-1], b[1:]):
        i0, i1 = rp[r0], rp[r1]
        if r1 - r0 == 1:  # CSR-vector: thread t walks i0 + t, i0 + t + 256, ...
            lanes = np.zeros(THREADS, ndt)
            for t in range(THREADS):
                for p in prod[i0 + t:i1:THREADS]:
                    lanes[t] = ndt(lanes[t] + p)
            warp0 = _tree(lanes, 32)[::32]
            s = ndt(0)
            for w in warp0:
                s = ndt(s + w)
            y[r0] = s
            continue
        assert i1 - i0 <= KP.CSR_BUDGET and r1 - r0 <= KP.CSR_BUDGET
        L = 32
        while L > 1 and L * (r1 - r0) > THREADS:
            L //= 2
        for r in range(r0, r1):  # CSR-stream: L lanes a row over the staged products
            seg = prod[rp[r]:rp[r + 1]]
            lanes = np.zeros(L, ndt)
            for lane in range(L):
                for p in seg[lane::L]:
                    lanes[lane] = ndt(lanes[lane] + p)
            y[r] = _tree(lanes, L)[0]
    y = torch.from_numpy(y)
    return y if scale is None else y * scale.to(acc)


@pytest.mark.parametrize("vd,xdt", [("f64", np.float64), ("f32", np.float64),
                                    ("f32", np.float32), ("bf16", np.float32),
                                    ("int8", np.float32)])
@pytest.mark.parametrize("name", MATRICES)
def test_block_span_reduction_matches_plain_and_reference(name, vd, xdt):
    ref_c = ref_csr(name)
    ref_c = ref_c if vd == "f64" else RF.with_value_dtype(ref_c, vd)
    c = to_port(ref_c)
    x = operand(c.shape[1], seed=31, dtype=xdt)
    xt = torch.from_numpy(x)
    blocks = KP.csr_row_blocks(c.row_ptr)
    got = emulate_row_blocks(c.row_ptr, c.col_idx, c.val, c.scale, xt, blocks)
    tol = 1e-12 if got.dtype == torch.float64 else 1e-5
    plain = KP.csr_spmv_plain(c.row_ptr, c.col_idx, c.val, c.scale, xt)
    assert got.dtype == plain.dtype and rel_err(got.numpy(), plain.numpy()) <= tol
    with x64(got.dtype == torch.float64):
        want = ref_apply(ref_c, "csr", "spmv", "xla", x)
    assert rel_err(got.numpy(), want) <= tol


def test_wrapper_keeps_its_cpu_path_with_row_blocks():
    c = to_port(ref_csr("ragged"))
    x = torch.from_numpy(operand(c.shape[1], seed=32, dtype=np.float64))
    blocks = KP.csr_row_blocks(c.row_ptr)
    want = KP.csr_spmv_plain(c.row_ptr, c.col_idx, c.val, c.scale, x)
    assert torch.equal(KP.csr_spmv_arrays(c.row_ptr, c.col_idx, c.val, c.scale, x, blocks),
                       want)
    assert isinstance(c, PF.CSR)
