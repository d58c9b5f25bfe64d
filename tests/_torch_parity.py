"""Shared pieces of the ``test_torch_*`` parity suites.

The same matrices, made from seeds, go through the JAX reference
(``repro``) and its PyTorch port (``repro_torch``).  Reference containers
reach the port through ``repro_torch.interop.from_reference_arrays``, so
both packages run on identical arrays.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

#: error budget per storage dtype against the f64 oracle, relative to the
#: oracle's max magnitude (the reference's VALUE_DTYPE_TOL): rounding of the
#: stored values, plus the per-group scale for int8/fp8
VALUE_DTYPE_TOL = {"f32": 1e-5, "bf16": 3e-2, "f16": 1e-2, "fp8_e4m3": 2e-1,
                   "int8": 5e-2}
VALUE_DTYPES = ("f64",) + tuple(VALUE_DTYPE_TOL)


def x64(on: bool = True):
    import jax
    return jax.enable_x64(True) if on else contextlib.nullcontext()


_MATS: dict = {}


def ref_matrix(name: str):
    """Reference CSR of a named test matrix (built once per process)."""
    if name not in _MATS:
        from repro.core import formats as RF
        from repro.core import matrices as RM
        build = {
            "surrogate600": lambda: RM.holstein_hubbard_surrogate(600, seed=1),
            "surrogate1200": lambda: RM.holstein_hubbard_surrogate(1200, seed=1),
            "surrogate3000": lambda: RM.holstein_hubbard_surrogate(3000, seed=2),
            "exact3": lambda: RM.holstein_hubbard_exact(
                RM.HolsteinHubbardParams(L=3)),
            "exact4": lambda: RM.holstein_hubbard_exact(),
            "laplace24": lambda: RM.laplacian_2d(24, 31),
            "laplace48": lambda: RM.laplacian_2d(48, 48),
            "powerlaw": lambda: RM.power_law_rows(2048, 2048, max_nnz=64),
            # the corpus's blocksparse spec: (8, 128) blocks at 25 % density
            "blocksparse": lambda: RF.CSR.from_dense(
                RM.block_sparse_dense(1024, 1024, (8, 128), 0.25, seed=4)),
        }[name]
        _MATS[name] = build()
    return _MATS[name]


_RAGGED: dict = {}


def ragged_csr_arrays():
    """``(row_ptr, col_idx, val, shape)`` (int32, int32, f64) of a CSR
    matrix with empty rows (a run of them included) and rows longer than
    the CUDA CSR kernel's 1024-nonzero row-block budget (one exactly at
    it), beside short rows.  Built once per process."""
    if "arrays" not in _RAGGED:
        rng = np.random.default_rng(21)
        n, ncols = 3000, 6000
        lens = rng.integers(0, 20, n)
        lens[rng.choice(n, 300, replace=False)] = 0
        lens[1000:1300] = 0
        lens[[7, 2000, 2999]] = [2049, 5000, 3000]
        lens[[500, 501]] = [1024, 1025]
        rp = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=rp[1:])
        col = np.concatenate([np.sort(rng.choice(ncols, k, replace=False)) for k in lens])
        _RAGGED["arrays"] = (rp.astype(np.int32), col.astype(np.int32),
                             rng.standard_normal(col.size), (n, ncols))
    return _RAGGED["arrays"]


def port_matrix(name: str):
    """The port's CSR of the same named matrix, from its own generators."""
    from repro_torch.core import formats as PF
    from repro_torch.core import matrices as PM
    return {
        "surrogate600": lambda: PM.holstein_hubbard_surrogate(600, seed=1),
        "surrogate1200": lambda: PM.holstein_hubbard_surrogate(1200, seed=1),
        "surrogate3000": lambda: PM.holstein_hubbard_surrogate(3000, seed=2),
        "exact3": lambda: PM.holstein_hubbard_exact(PM.HolsteinHubbardParams(L=3)),
        "exact4": lambda: PM.holstein_hubbard_exact(),
        "laplace24": lambda: PM.laplacian_2d(24, 31),
        "laplace48": lambda: PM.laplacian_2d(48, 48),
        "powerlaw": lambda: PM.power_law_rows(2048, 2048, max_nnz=64),
        "blocksparse": lambda: PF.CSR.from_dense(
            PM.block_sparse_dense(1024, 1024, (8, 128), 0.25, seed=4)),
    }[name]()


def as_np(a) -> np.ndarray:
    """numpy view of a reference array or a port tensor; bf16/fp8 as their
    raw bits so that comparisons are bitwise."""
    import torch
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    return a


def assert_same_array(ref, port, what: str = ""):
    if ref is None or port is None:
        assert ref is None and port is None, what
        return
    r, p = as_np(ref), as_np(port)
    assert r.dtype == p.dtype, f"{what}: dtype {r.dtype} != {p.dtype}"
    assert r.shape == p.shape, f"{what}: shape {r.shape} != {p.shape}"
    assert np.array_equal(r, p), f"{what}: values differ"


#: array fields of each container kind
_FIELDS = {
    "COO": ("rows", "cols", "vals", "scale"),
    "CSR": ("row_ptr", "col_idx", "val", "scale"),
    "ELL": ("col_idx", "val", "scale"),
    "JDS": ("jd_ptr", "col_idx", "val", "perm", "scale"),
    "SELL": ("chunk_ptr", "chunk_width", "col_idx", "val", "perm", "scale"),
    "BSR": ("block_row_ptr", "block_col_idx", "blocks", "scale"),
    "DIA": ("offsets", "data", "scale"),
    "MatrixFreeOperator": ("data",),
}


def assert_same_container(ref, port):
    """Bitwise equality of every packed array and scalar field."""
    kind = type(ref).__name__
    assert type(port).__name__ == kind
    assert tuple(ref.shape) == tuple(port.shape)
    if kind == "HybridDIA":
        assert_same_container(ref.dia, port.dia)
        assert_same_container(ref.rest, port.rest)
        return
    for f in _FIELDS[kind]:
        assert_same_array(getattr(ref, f), getattr(port, f), f"{kind}.{f}")
    if kind in ("SELL", "ELL"):
        assert ref.nnz == port.nnz
    if kind == "SELL":
        assert (ref.C, ref.sigma) == (port.C, port.sigma)
    if kind == "BSR":
        assert tuple(ref.block_shape) == tuple(port.block_shape)
    if kind == "MatrixFreeOperator":
        for f in ("offsets", "periods", "los", "his", "gen_values", "nnz",
                  "stored_nnz", "value_dtype"):
            assert getattr(ref, f) == getattr(port, f), f


def to_port(ref):
    """The port's container holding the reference container's arrays."""
    from repro_torch.interop import from_reference_arrays
    kind = {"COO": "coo", "CSR": "csr", "ELL": "ell", "JDS": "jds",
            "SELL": "sell", "BSR": "bsr", "DIA": "dia",
            "HybridDIA": "hybrid", "MatrixFreeOperator": "matrix_free"}[
                type(ref).__name__]
    if kind == "hybrid":
        return from_reference_arrays(
            "hybrid",
            {"dia": _arrays(ref.dia), "rest": _arrays(ref.rest)},
            {"shape": ref.shape, "rest": _meta(ref.rest)})
    return from_reference_arrays(kind, _arrays(ref), {"shape": ref.shape, **_meta(ref)})


def _arrays(ref) -> dict:
    return {f: getattr(ref, f) for f in _FIELDS[type(ref).__name__]}


def _meta(ref) -> dict:
    skip = set(_FIELDS[type(ref).__name__]) | {"shape"}
    return {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)
            if f.name not in skip}


def operand(n: int, k: int | None = None, seed: int = 0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k is None else (n, k)).astype(dtype)


def ref_apply(obj, fmt: str, op: str, backend: str, x: np.ndarray) -> np.ndarray:
    """The reference registry entry's output on ``x`` (run under x64 when
    ``x`` or the stored values are f64)."""
    import jax.numpy as jnp
    from repro.kernels import registry as RR
    fn = RR.build(obj, fmt, op, backend).fn
    return np.asarray(fn(jnp.asarray(x)))


def port_apply(obj, fmt: str, op: str, backend: str, x: np.ndarray) -> np.ndarray:
    """The port registry entry's output on ``x``, on the CPU."""
    import torch
    from repro_torch.kernels import registry as PR
    ctx = PR.KernelContext(device=torch.device("cpu"))
    fn = PR.build(obj, fmt, op, backend, ctx).fn
    return fn(torch.from_numpy(x)).numpy()


def rel_err(out: np.ndarray, ref: np.ndarray) -> float:
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out.astype(np.float64) - ref.astype(np.float64)).max()
                 / max(1e-300, float(np.abs(ref).max())))


def ref_sell_spmm_pallas(ref_c, X: np.ndarray) -> np.ndarray:
    """The reference's Pallas SELL SpMM (interpreted, as the reference's own
    tests run it), its per-chunk scale and its inverse-permutation scatter,
    on a reference SELL container: Y (n_rows, K).  The chunk block is the
    largest of 8, 4, 2, 1 that divides the chunk count."""
    import jax.numpy as jnp
    from repro.kernels import sell as RS
    from repro.kernels import sell_spmv as RK
    col3, val3, _ = ref_c.padded_views()
    cb = next(b for b in (8, 4, 2, 1) if ref_c.n_chunks % b == 0)
    tiles = RK.sell_spmm_arrays(jnp.asarray(col3), jnp.asarray(val3), jnp.asarray(X),
                                chunk_block=cb, interpret=True)
    if ref_c.scale is not None:
        tiles = tiles * jnp.asarray(ref_c.scale).astype(tiles.dtype)[:, None, None]
    return np.asarray(RK.sell_spmm_scatter(tiles, RS._perm_arg(ref_c), ref_c.shape[0]))


def ref_sell_spmv_pallas(ref_c, x: np.ndarray) -> np.ndarray:
    """The reference's Pallas SELL SpMV (interpreted, as the reference's own
    tests run it), its per-chunk scale and ``sell_spmv_scatter``, on a
    reference SELL container: y (n_rows,).  The chunk block is the largest
    of 8, 4, 2, 1 that divides the chunk count."""
    import jax.numpy as jnp
    from repro.kernels import sell as RS
    from repro.kernels import sell_spmv as RK
    col3, val3, _ = ref_c.padded_views()
    cb = next(b for b in (8, 4, 2, 1) if ref_c.n_chunks % b == 0)
    tiles = RK.sell_spmv_arrays(jnp.asarray(col3), jnp.asarray(val3), jnp.asarray(x),
                                chunk_block=cb, interpret=True)
    if ref_c.scale is not None:
        tiles = tiles * jnp.asarray(ref_c.scale).astype(tiles.dtype)[:, None]
    return np.asarray(RK.sell_spmv_scatter(tiles, RS._perm_arg(ref_c), ref_c.shape[0]))
