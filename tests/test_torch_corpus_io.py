"""The port's matrix corpus, generators and MatrixMarket I/O, held against
the reference (``repro.core.{matrices,corpus,io}``).  Packed arrays and
written bytes must be bitwise equal; ``stats`` integers exact and floats
to 1e-12 relative; malformed files raise the same exception class with the
same line and message."""
import gzip
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from _torch_parity import assert_same_container, to_port  # noqa: E402
from repro.core import corpus as RC  # noqa: E402
from repro.core import io as RIO  # noqa: E402
from repro.core import matrices as RM  # noqa: E402
from repro.core import validate as RV  # noqa: E402
from repro_torch.core import corpus as PC  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core import io as PIO  # noqa: E402
from repro_torch.core import matrices as PM  # noqa: E402
from repro_torch.core import validate as PV  # noqa: E402

MALFORMED = Path(__file__).parent / "fixtures" / "malformed"
#: relative tolerance of the float statistics (the same numpy reductions on
#: the same arrays; only their order of evaluation may differ)
STATS_RTOL = 1e-12


@pytest.mark.parametrize("name,args", [
    ("random_sparse", dict(n_rows=300, n_cols=257, nnz_per_row=7, seed=4)),
    ("random_sparse", dict(n_rows=50, n_cols=5, nnz_per_row=9, seed=1)),
    ("random_banded", dict(n=400, half_bandwidth=9, density=0.6, seed=2)),
    ("random_banded", dict(n=64, half_bandwidth=63, density=0.3, seed=3, dtype=np.float64)),
    ("laplacian_3d", dict(nx=5, ny=7, nz=3)),
    ("laplacian_3d", dict(nx=1, ny=4, nz=6, dtype=np.float32)),
    ("dense_stripe", dict(n=300, stripe_width=17, seed=5)),
    ("dense_stripe", dict(n=64, stripe_width=8, stripe_start=0, seed=6)),
])
def test_generators_bitwise(name, args):
    assert_same_container(getattr(RM, name)(**args), getattr(PM, name)(**args))


def test_dense_stripe_refuses_a_stripe_outside_the_matrix():
    with pytest.raises(ValueError, match="outside"):
        PM.dense_stripe(10, 4, stripe_start=8)


def test_corpus_registry_matches_reference():
    assert PC.names() == RC.names()
    assert PC.matrix_free_names() == RC.matrix_free_names()
    for r, p in zip(RC.specs(), PC.specs()):
        assert (p.family, p.formats, p.sell_C, p.sell_sigma, p.matrix_free,
                p.convert_kwargs) == (r.family, r.formats, r.sell_C, r.sell_sigma,
                                      r.matrix_free, r.convert_kwargs)
        assert p.sell_kwargs() == r.sell_kwargs()
    with pytest.raises(KeyError, match="unknown corpus matrix"):
        PC.get("nope")
    with pytest.raises(ValueError, match="already registered"):
        PC.register(PC.get("laplace2d"))


def _same_stats(a: dict, b: dict, where: str):
    assert a.keys() == b.keys(), (where, set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], float):
            assert abs(a[k] - b[k]) <= STATS_RTOL * max(1.0, abs(a[k])), (where, k)
        elif isinstance(a[k], dict):
            _same_stats(a[k], b[k], f"{where}.{k}")
        else:
            assert a[k] == b[k], (where, k, a[k], b[k])


@pytest.mark.parametrize("name", RC.names())
def test_corpus_spec_builds_bitwise_and_stats_match(name):
    r, p = RC.build(name), PC.build(name)
    assert isinstance(p, PF.CSR)
    assert_same_container(r, p)
    assert PC.build(name) is p                      # cached per name
    assert getattr(p, "_source", None) == getattr(r, "_source", None)
    _same_stats(RC.stats(name), PC.stats(name), name)


@pytest.mark.parametrize("name", RC.matrix_free_names())
def test_matrix_free_operators_match(name):
    r, p = RC.matrix_free_operator(name), PC.matrix_free_operator(name)
    assert_same_container(r, p)


def test_matrix_free_operator_refuses_an_unflagged_spec():
    with pytest.raises(ValueError, match="not matrix-free-eligible"):
        PC.matrix_free_operator("powerlaw")


def test_clear_cache_rebuilds_the_same_arrays():
    a = PC.build("stripe")
    PC.clear_cache()
    b = PC.build("stripe")
    assert a is not b
    assert_same_container(a, b)


def test_row_length_histogram_matches():
    lens = np.random.default_rng(0).integers(0, 300, 1000)
    assert PC.row_length_histogram(lens) == RC.row_length_histogram(lens)
    assert PC.row_length_histogram(np.zeros(0, np.int64)) == \
        RC.row_length_histogram(np.zeros(0, np.int64))


# --- MatrixMarket files ---------------------------------------------------------

def test_read_committed_corpus_file_bitwise():
    path = PIO.CORPUS_DIR / "demo_lap2d_24.mtx.gz"
    assert path == RIO.CORPUS_DIR / "demo_lap2d_24.mtx.gz" and path.is_file()
    r, p = RIO.read_mtx(path), PIO.read_mtx(path)
    assert_same_container(r, p)
    assert p._source == r._source == str(path)


_MALFORMED_CASES = sorted(f.name for f in MALFORMED.glob("*.mtx"))


def test_every_malformed_fixture_is_covered():
    assert len(_MALFORMED_CASES) == 8


@pytest.mark.parametrize("fixture", _MALFORMED_CASES)
@pytest.mark.parametrize("validate", ("strict", "repair", "off"))
def test_malformed_files_raise_like_the_reference(fixture, validate):
    path = MALFORMED / fixture
    try:
        want = RIO.read_mtx(path, validate=validate)
    except ValueError as e:
        want = e
    try:
        got = PIO.read_mtx(path, validate=validate)
    except ValueError as e:
        got = e
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
        assert getattr(got, "line", None) == getattr(want, "line", None)
        assert getattr(got, "path", None) == getattr(want, "path", None)
        if isinstance(want, RV.MatrixFormatError):
            assert isinstance(got, PV.MatrixFormatError)
    else:
        assert not isinstance(got, Exception), got
        for f in ("rows", "cols", "vals"):     # NaN values (policy "off") equal
            a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), f
        assert got._source == want._source
        assert getattr(got, "_repairs", None) == getattr(want, "_repairs", None)


def _write_cases():
    rng = np.random.default_rng(8)
    sym = RM.laplacian_2d(7, 5)
    dense = rng.standard_normal((12, 12))
    skew = np.tril(dense, -1) - np.tril(dense, -1).T
    return {"general": RM.random_sparse(40, 31, 5, seed=0), "symmetric": sym,
            "skew-symmetric": RIO.COO(*np.nonzero(skew), skew[np.nonzero(skew)], (12, 12))}


@pytest.mark.parametrize("suffix", (".mtx", ".mtx.gz"))
@pytest.mark.parametrize("field", ("real", "integer", "pattern"))
@pytest.mark.parametrize("symmetry", ("general", "symmetric", "skew-symmetric"))
def test_write_mtx_bytes_identical(tmp_path, field, symmetry, suffix):
    ref = _write_cases()[symmetry]
    if field == "integer":
        v = np.asarray(ref.to_coo().vals if hasattr(ref, "to_coo") else ref.vals)
        coo = ref.to_coo() if hasattr(ref, "to_coo") else ref
        ref = RIO.COO(np.asarray(coo.rows), np.asarray(coo.cols),
                      np.round(np.asarray(v) * 7), ref.shape)
    port = to_port(ref)
    kw = dict(field=field, symmetry=symmetry, comment="written by both packages")
    a = RIO.write_mtx(tmp_path / "ref" / f"m{suffix}", ref, **kw)
    b = PIO.write_mtx(tmp_path / "port" / f"m{suffix}", port, **kw)
    opener = gzip.open if suffix.endswith(".gz") else open      # decompressed bytes
    with opener(a, "rb") as fa, opener(b, "rb") as fb:
        ra, rb = fa.read(), fb.read()
    assert ra == rb and len(ra) > 100


def test_write_mtx_blocks_and_precision(tmp_path, monkeypatch):
    """Several write blocks (the block size shrunk to 7 entries) and a
    short precision give the reference's bytes."""
    monkeypatch.setattr(PIO, "_WRITE_BLOCK", 7)
    ref = RM.random_banded(60, 3, 0.7, seed=9, dtype=np.float64)
    port = to_port(ref)
    for prec in (17, 6):
        a = RIO.write_mtx(tmp_path / f"r{prec}.mtx", ref, precision=prec)
        b = PIO.write_mtx(tmp_path / f"p{prec}.mtx", port, precision=prec)
        assert a.read_bytes() == b.read_bytes()


def test_write_then_read_round_trips_bitwise(tmp_path):
    m = PM.holstein_hubbard_surrogate(500, seed=3)
    p = PIO.write_mtx(tmp_path / "s.mtx", m)
    back = PIO.load_matrix("s", search_dirs=[tmp_path])
    assert_same_container(m, back)
    assert back._source == str(p)


def test_write_mtx_refuses_unknown_field_and_symmetry(tmp_path):
    m = PM.laplacian_2d(3, 3)
    with pytest.raises(ValueError, match="field"):
        PIO.write_mtx(tmp_path / "x.mtx", m, field="complex")
    with pytest.raises(ValueError, match="symmetry"):
        PIO.write_mtx(tmp_path / "x.mtx", m, symmetry="hermitian")


@pytest.mark.parametrize("name,n", [("external_band_1024", 1024), ("abc", 64),
                                    ("no_such_matrix_xyz", 512)])
def test_synthetic_fallback_bitwise(name, n):
    r, p = RIO.synthetic_fallback(name, n=n), PIO.synthetic_fallback(name, n=n)
    assert_same_container(r, p)
    assert p._source == r._source == f"synthetic:{name}"


def test_load_matrix_from_disk_and_fallback(tmp_path):
    m = RM.random_sparse(16, 16, 3, seed=3)
    RIO.write_mtx(tmp_path / "present.mtx", m)
    r = RIO.load_matrix("present", search_dirs=[tmp_path])
    p = PIO.load_matrix("present", search_dirs=[tmp_path])
    assert_same_container(r, p)
    assert p._source == r._source
    assert PIO.resolve_matrix_path("absent", [tmp_path]) is None
    fb = PIO.load_matrix("absent", search_dirs=[tmp_path], fallback_n=64)
    assert fb._source == "synthetic:absent"
    assert_same_container(RIO.load_matrix("absent", search_dirs=[tmp_path], fallback_n=64), fb)


def test_load_matrix_names_an_overflowing_cast(tmp_path):
    (tmp_path / "big.mtx").write_text(
        "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1e300\n2 2 1.0\n")
    for mod in (RIO, PIO):
        with pytest.raises(ValueError, match="overflow to Inf when cast to float32"):
            mod.load_matrix("big", search_dirs=[tmp_path])
    ok = PIO.load_matrix("big", search_dirs=[tmp_path], dtype=np.float64)
    assert float(ok.val[0]) == 1e300


def test_corpus_dir_override(tmp_path, monkeypatch):
    m = RM.random_sparse(12, 12, 2, seed=5)
    RIO.write_mtx(tmp_path / "demo_lap2d_24.mtx", m)
    monkeypatch.setenv("REPRO_CORPUS_DIR", str(tmp_path))
    r, p = RIO.load_matrix("demo_lap2d_24"), PIO.load_matrix("demo_lap2d_24")
    assert_same_container(r, p)
    assert p._source == str(tmp_path / "demo_lap2d_24.mtx")
    assert PIO.resolve_matrix_path("demo_lap2d_24") == tmp_path / "demo_lap2d_24.mtx"
    monkeypatch.delenv("REPRO_CORPUS_DIR")
    assert PIO.resolve_matrix_path("demo_lap2d_24") == \
        PIO.CORPUS_DIR / "demo_lap2d_24.mtx.gz"
