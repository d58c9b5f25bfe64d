"""The generators found by name under ``spmvbench/generators/``: each
configuration's record holds ``spmvbench/gen.py``'s arrays bit for bit and
a reference that computes as ``CsrRef``; a configuration whose generator
hands over no CSR runs a cell end to end on its own reference; an unknown
generator stops set-up."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from conftest import tiny
from repro_torch.core.plan import SpMVPlan

from spmvbench import gen, generators, reference, run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
#: a cell of each configuration
CELL_OF = {c["config"]: c["name"] for c in reversed(BENCH["workloads"])}
NO_CSR_CELL = "hmep_exact.lanczos"


@pytest.mark.parametrize("config", sorted(CELL_OF))
def test_record_is_the_frozen_generator_bit_for_bit(config):
    f = tiny(CELL_OF[config])
    b = run.Bench(CELL_OF[config], f["config"], f["traffic"], 2**33 + 5, 0.3, False, "cpu")
    b.build_matrix()
    params = dict(b.config["params"])
    if b.config.get("seeded"):
        params["seed"] = b.subseed(0)
    want = getattr(gen, b.config["generator"])(**params, dtype=np.dtype(b.value_dtype).type)
    got = b.matrix.csr
    assert all(g.dtype == w.dtype and g.tobytes() == w.tobytes() for g, w in zip(got, want))
    n = len(want[0]) - 1
    diag = np.count_nonzero(np.repeat(np.arange(n), np.diff(want[0])) == want[1])
    assert (b.n, b.nnz, b.n_diag) == (n, len(want[1]), diag)

    x = torch.randn(b.n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(b.subseed(9)))
    ours, theirs = b.reference(), reference.CsrRef(*want, "cpu")
    store, sums = reference.control_precision(b.vector_dtype)
    assert torch.equal(ours.spmv(x, torch.float64), theirs.spmv(x, torch.float64))
    assert torch.equal(ours.spmv(x, sums, store), theirs.spmv(x, sums, store))


def _no_csr_build(params: dict, dtype) -> generators.Matrix:
    """The Holstein-Hubbard chain's record with its arrays dropped: only the
    sizes and a reference built on the host are kept."""
    m = generators.from_csr(*gen.holstein_hubbard(**params, dtype=dtype))
    ref = m.reference("cpu")

    def on(device):
        assert torch.device(device).type == "cpu"
        return ref

    return generators.Matrix(n=m.n, nnz=m.nnz, n_diag=m.n_diag, csr=None, reference=on)


@pytest.fixture
def no_csr(monkeypatch):
    """A generator ``holstein_hubbard_no_csr`` beside the files, and a
    recorder of every reference solve the Lanczos check makes."""
    from spmvbench.drivers import lanczos

    load = run.load_generator
    monkeypatch.setattr(run, "load_generator", lambda name: (
        types.SimpleNamespace(build=_no_csr_build) if name == "holstein_hubbard_no_csr"
        else load(name)))
    solves: dict[int, tuple] = {}
    orig = lanczos._reference_runs

    def recorded(b, kept, dtype):
        out = orig(b, kept, dtype)
        solves.update({k[0]: r for k, r in zip(kept, out)})
        return out

    monkeypatch.setattr(lanczos, "_reference_runs", recorded)
    return solves


def _run(generator: str | None, seed: int = 2**35 + 3) -> dict:
    f = tiny(NO_CSR_CELL, check_all=True)
    if generator:
        f["config"]["generator"] = generator
    return run.run_cell(NO_CSR_CELL, seed, 0.3, False, "cpu", out=lambda s: None, **f)


def test_a_configuration_without_csr_runs_its_cell(no_csr):
    line = _run(None)
    with_csr = dict(no_csr)
    no_csr.clear()
    line_no_csr = _run("holstein_hubbard_no_csr")
    assert line["correct"] is True and line_no_csr["correct"] is True, line_no_csr["checks"]
    assert line_no_csr["metrics"].keys() == line["metrics"].keys()
    common = with_csr.keys() & no_csr.keys()
    assert 0 in common
    for i in common:
        (a, bt, e0), (a2, bt2, e02) = with_csr[i], no_csr[i]
        assert a.tobytes() == a2.tobytes() and bt.tobytes() == bt2.tobytes() and e0 == e02


def test_a_configuration_without_csr_reads_an_altered_answer_incorrect(no_csr, monkeypatch):
    from test_bench_faults import FAULTS

    method, patch = FAULTS["answer_altered"]
    monkeypatch.setattr(SpMVPlan, method, patch(getattr(SpMVPlan, method)))
    line = _run("holstein_hubbard_no_csr", seed=424242)
    assert line["correct"] is False, line["checks"]


def test_program_matrix_refuses_a_record_without_csr(no_csr):
    f = tiny(NO_CSR_CELL)
    f["config"]["generator"] = "holstein_hubbard_no_csr"
    b = run.Bench(NO_CSR_CELL, f["config"], f["traffic"], 1, 0.3, False, "cpu")
    b.build_matrix()
    assert b.matrix.csr is None and b.n == 5600
    with pytest.raises(ValueError, match="hands over no CSR"):
        b.program_matrix()


def test_unknown_generator_fails_in_setup():
    f = tiny("hmep.spmv")
    f["config"]["generator"] = "no_such_generator"
    with pytest.raises(FileNotFoundError, match="spmvbench/generators/no_such_generator.py"):
        run.run_cell("hmep.spmv", 1, 0.3, False, "cpu", out=lambda s: None, **f)
