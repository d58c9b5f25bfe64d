"""The ``cuda`` slab operands of the distributed plans, on the CPU.

``kernels.slab.slab_chunks`` derives, from the reference-bitwise host
``ShardSlabs``, the SELL-C descriptor that kernels 1 and 5 run: the chunks
the packer skipped (all rows empty) as zero-width chunks, the rows padded to
``rows_pp`` at the end of the permutation, the descriptor ending at the
block's real chunks (not at the stacked tail), and an ``ell`` block relaid
into chunks of 8 rows.  Here every block's descriptor goes through the
kernels' plain versions (``sell_spmv_arrays`` / ``sell_spmm_arrays`` on CPU
tensors) and is held against the ``torch`` slab entry on the host arrays,
and the whole ``cuda`` executor runs on a CPU mesh with the kernels' plain
versions standing in (the entries' probe opened), launch by launch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import port_matrix, ragged_csr_arrays
from repro_torch.core import distributed as D
from repro_torch.core import distributed_plan as DP
from repro_torch.core import formats as PF
from repro_torch.core.planconfig import PlanConfig
from repro_torch.kernels import registry as PR
from repro_torch.kernels import slab as S
from repro_torch.kernels.sell_spmv import ChunkBlocks, ChunkSchedule


def ragged():
    rp, col, val, shape = ragged_csr_arrays()
    return PF.CSR(rp, col, val.astype(np.float32), shape)


MATRICES = {"ragged": ragged, "laplace48": lambda: port_matrix("laplace48"),
            "powerlaw": lambda: port_matrix("powerlaw")}

#: the descriptor's result against the torch entry's on the same block, f64
TOL = 1e-12


def _blocks(m, parts, balance, pack, local_cols):
    b = DP.pack_shard_slabs(m, parts, balance=balance, pack=pack, local_cols=local_cols)
    return b, D.block_lengths(m, b.bounds, local_cols)


def _arrays(b, p, q):
    t = torch.from_numpy
    return S.SlabArrays(t(b.col[p, q]), t(b.val[p, q]),
                        None if b.rid is None else t(b.rid[p, q]))


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("local_cols", (False, True), ids=("Q1", "QP"))
@pytest.mark.parametrize("pack", ("sell", "ell"))
def test_descriptor_through_plain_kernels(name, pack, local_cols):
    m = MATRICES[name]()
    rng = np.random.default_rng(5)
    seen = {"zero_width": 0, "pad_rows": 0, "tail": 0, "empty": 0}
    for parts, balance in ((3, "rows"), (4, "nnz")):
        b, lens = _blocks(m, parts, balance, pack, local_cols)
        x = torch.from_numpy(rng.standard_normal(b.col_shard * parts))
        X = torch.from_numpy(rng.standard_normal((b.col_shard * parts, 3)))
        for p in range(parts):
            nr = int(b.bounds[p + 1] - b.bounds[p])
            seen["pad_rows"] += nr < b.rows_pp
            for q in range(b.q_blocks):
                xs = x if not local_cols else x[q * b.col_shard:(q + 1) * b.col_shard]
                Xs = X if not local_cols else X[q * b.col_shard:(q + 1) * b.col_shard]
                arrays = _arrays(b, p, q)
                want = S._sell_mult(b.rows_pp)(arrays, xs) if pack == "sell" else \
                    S._ell_mult(b.rows_pp)(arrays, xs)
                want_mm = S._sell_mult(b.rows_pp)(arrays, Xs) if pack == "sell" else \
                    S._ell_mult(b.rows_pp)(arrays, Xs)
                d = S.slab_chunks(pack, b.col[p, q], b.val[p, q], lens[p, q], 8)
                if d is None:
                    seen["empty"] += 1
                    assert lens[p, q].sum() == 0 and not want.any()
                    continue
                _check_descriptor(d, b, p, q, lens[p, q], pack)
                seen["zero_width"] += int((d["chunk_width"] == 0).sum())
                seen["tail"] += pack == "sell" and d["col"].shape[0] < b.col.shape[2]
                op = S.chunks_on(d, "cpu")
                got = S._cuda_spmv(b.rows_pp)(op, xs)
                assert float((got - want).abs().max()) <= TOL * max(1.0, float(want.abs().max()))
                got_mm = S._cuda_spmm(b.rows_pp)(op, Xs)
                assert float((got_mm - want_mm).abs().max()) <= TOL * max(
                    1.0, float(want_mm.abs().max()))
                # add_to: the product added into the running result in place
                base = torch.from_numpy(rng.standard_normal(b.rows_pp))
                acc = base.clone()
                assert S._cuda_spmv(b.rows_pp)(op, xs, add_to=acc) is acc
                assert float((acc - (base + want)).abs().max()) <= TOL * max(
                    1.0, float(acc.abs().max()))
    # the matrices reach every trouble the derivation handles
    if name == "ragged":
        assert seen["zero_width"] and seen["pad_rows"]
        assert seen["tail"] or pack == "ell"
    if name == "laplace48" and local_cols:
        assert seen["empty"]


def _check_descriptor(d, b, p, q, lens, pack):
    """The invariants the kernels rely on, and the descriptor against the
    host arrays slot by slot."""
    C, rows_pp = d["C"], d["n_rows"]
    cp, cw, perm = d["chunk_ptr"], d["chunk_width"], d["perm"]
    nc = cw.shape[0]
    assert rows_pp == b.rows_pp and nc == -(-rows_pp // C)
    assert np.array_equal(np.diff(cp), cw.astype(np.int64) * C) and cp[-1] == d["col"].shape[0]
    assert np.array_equal(np.sort(perm[:rows_pp]), np.arange(rows_pp))  # every row once
    assert (perm[rows_pp:] == rows_pp).all()                             # pads at the end
    # every chunk's width is its longest row's, so every stored slot is read
    rows = perm.reshape(nc, C)
    lane_len = np.where(rows < rows_pp, lens[np.minimum(rows, rows_pp - 1)], 0)
    assert np.array_equal(cw, lane_len.max(axis=1))
    ChunkBlocks(cp, cw, C)
    ChunkSchedule(np.argsort(np.arange(nc)))
    # slot k of the descriptor: its chunk, lane, row and position in the row
    chunk_of = np.repeat(np.arange(nc), cw.astype(np.int64) * C)
    k = np.arange(cp[-1]) - cp[chunk_of]
    row = perm[chunk_of * C + k % C]
    real = (row < rows_pp) & (k // C < np.where(row < rows_pp, lens[np.minimum(
        row, rows_pp - 1)], 0))
    assert int(real.sum()) == int(lens.sum())
    if pack == "sell":  # a sell block is stored as the descriptor reads it
        rid = b.rid[p, q]
        assert np.array_equal(rid[:cp[-1]], np.where(real, row, rows_pp))
        assert (rid[cp[-1]:] == rows_pp).all() and not b.val[p, q][cp[-1]:].any()
        assert np.array_equal(d["col"], b.col[p, q][:cp[-1]])
    else:  # the ell block relaid: each real slot holds its row's entry
        r, j = row[real], k[real] // C
        assert np.array_equal(d["col"][real], b.col[p, q][r, j])
        assert np.array_equal(d["val"][real], b.val[p, q][r, j])
        assert not d["val"][~real].any()


@pytest.fixture
def cuda_entries_on_host(monkeypatch):
    """The ``cuda`` slab entries with their probe opened, and counters on
    the two kernel wrappers they call: on CPU tensors the wrappers run the
    kernels' plain versions."""
    for e in PR.entries():
        if e.format.startswith("slab_") and e.backend == "cuda":
            monkeypatch.setitem(PR._TABLE, e.key, dataclasses.replace(e, probe=PR._probe_ok))
    monkeypatch.setattr(PR, "probe_cuda", lambda m, ctx: PR.CAP_OK)
    calls = {"sell_spmv": 0, "sell_spmm": 0}
    for name in calls:
        fn = getattr(S, f"{name}_arrays")

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(S, f"{name}_arrays", counted)
    return calls


@pytest.mark.parametrize("parts", (1, 4, 8))
@pytest.mark.parametrize("variant", DP.VARIANTS)
def test_cuda_executor_on_host(cuda_entries_on_host, variant, parts):
    """The cuda executor (plain kernels) against the torch executor and a
    numpy product; one kernel call a non-empty block, nothing for an empty
    one."""
    calls = cuda_entries_on_host
    rng = np.random.default_rng(parts)
    for name in ("laplace48", "ragged"):
        m = MATRICES[name]()
        d = m.to_dense().astype(np.float64)
        x = rng.standard_normal(m.shape[1])
        X = rng.standard_normal((m.shape[1], 4))
        mesh = D.make_mesh_1d(n_devices=parts, device="cpu")
        for slab in ("sell", "ell"):
            p = DP.compile_distributed_spmv_plan(m, mesh, variant=variant, slab_format=slab)
            t = DP.compile_distributed_spmv_plan(m, mesh, variant=variant, slab_format=slab,
                                                 config=PlanConfig(backend="torch"))
            assert p.slab_backend == "cuda" and t.slab_backend == "torch"
            blocks = sum(op is not None for row in p.operands for op in row)
            want = parts if variant == "allgather" else parts * parts
            assert blocks <= want and (blocks < want) == any(
                op is None for row in p.operands for op in row)
            before = dict(calls)
            y = p(torch.from_numpy(x))
            Y = p.spmm(torch.from_numpy(X))
            assert calls["sell_spmv"] - before["sell_spmv"] == blocks
            assert calls["sell_spmm"] - before["sell_spmm"] == blocks
            for got, ref in ((y, d @ x), (Y, d @ X), (t(torch.from_numpy(x)), d @ x)):
                assert float(np.abs(got.numpy() - ref).max()) <= 1e-12 * np.abs(ref).max()
            assert torch.equal(y, p(torch.from_numpy(x)))  # two calls, same bits
            y32 = p(torch.from_numpy(x.astype(np.float32)))
            assert y32.dtype == (torch.float64 if m.val.dtype == torch.float64
                                 else torch.float32)
            assert float(np.abs(y32.numpy() - d @ x).max()) <= 2e-5 * np.abs(d @ x).max()
