"""The port's tuning DB (``repro_torch.core.tunedb``) and the warm paths of
``select_format`` / ``select_backend`` / ``SpMVPlan.compile``, held against
the reference's.  Signatures must be the same strings; a DB recorded with
the same candidates saves to the same JSON and each package reads the
other's file; warm picks and the efficiency refit (to 1e-12) agree; a
corrupt, stale or foreign-family DB falls back to the cold pick; a
runnable ``cuda`` entry is picked whatever the DB says.

The reference's backend names map to the port's as ``xla`` -> ``torch``,
``pallas`` -> ``cuda``.  The port keys a record by the type of the plan's
device (``cpu`` here); the reference by ``jax.default_backend()``, also
``cpu`` here.
"""
import dataclasses
import warnings

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import corpus as RC  # noqa: E402
from repro.core import formats as RF  # noqa: E402
from repro.core import perfmodel as RPM  # noqa: E402
from repro.core import tunedb as RT  # noqa: E402
from repro.core.plan import _convert_cached as ref_convert_cached  # noqa: E402
from repro.kernels import registry as RR  # noqa: E402
from repro.utils import hw as RHW  # noqa: E402
from repro_torch.core import corpus as PC  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core import perfmodel as PM  # noqa: E402
from repro_torch.core import tunedb as PT  # noqa: E402
from repro_torch.core.plan import SpMVPlan, _convert_cached  # noqa: E402
from repro_torch.core.planconfig import PlanConfig  # noqa: E402
from repro_torch.kernels import registry as PR  # noqa: E402
from repro_torch.utils.hw import H100, ChipSpec  # noqa: E402

RCHIP = RHW.TPU_V5E
CHIP = ChipSpec(RCHIP.name, RCHIP.peak_flops_fp32, RCHIP.peak_flops_fp32 / 2,
                RCHIP.hbm_bytes_per_s)
BACKEND = {"xla": "torch", "pallas": "cuda", "loop_reference": "loop_reference"}
CPU = torch.device("cpu")


def _cands(mod, spec, backend="xla"):
    """Candidates built from (format, seconds, kwargs, eff1 seconds)."""
    be = backend if mod is RT else BACKEND[backend]
    return [mod.Candidate(format=f, backend=be, t_measured_s=t, t_model_s=t * 0.8,
                          t_model_eff1_s=t1, convert_kwargs=dict(kw))
            for f, t, kw, t1 in spec]


POWERLAW = [("sell", 1e-5, {"C": 8, "sigma": 64}, 4e-6), ("csr", 3e-5, {}, 2e-6),
            ("jds", 7e-5, {}, 1e-5)]


@pytest.fixture(scope="module")
def powerlaw():
    return RC.build("powerlaw"), PC.build("powerlaw")


@pytest.mark.parametrize("name", RC.names())
def test_signatures_equal_the_references(name):
    r, p = RC.build(name), PC.build(name)
    sig = PT.signature_of(p)
    assert sig == RT.signature_of(r) and len(sig) == 16
    # a new object with the same pattern signs the same (no identity)
    fresh = PF.CSR(p.row_ptr.clone(), p.col_idx.clone(), p.val.clone(), p.shape)
    assert PT.signature_of(fresh) == sig and fresh._tune_sig == sig
    assert PT.signature_of(p.to_coo()) == sig
    if RC.get(name).matrix_free:
        ro, po = RC.matrix_free_operator(name), PC.matrix_free_operator(name)
        assert PT.signature_of(po) == RT.signature_of(ro)


def test_matrix_free_signature_reads_stored_lanes_and_value_dtype():
    op = PC.matrix_free_operator("banded_narrow")
    ro = RC.matrix_free_operator("banded_narrow")
    for vd in ("f64", "bf16"):
        p, r = PF.with_value_dtype(op, vd), RF.with_value_dtype(ro, vd)
        assert PT.signature_of(p) == RT.signature_of(r)
    assert PT.signature_of(PF.with_value_dtype(op, "bf16")) != PT.signature_of(op)


def test_converted_containers_sign_through_their_source(powerlaw):
    _, p = powerlaw
    sig = PT.signature_of(p)
    s1 = _convert_cached(p, "sell", {"C": 8, "sigma": 64})
    s2 = _convert_cached(p, "sell", {"C": 16, "sigma": 128})
    assert s1._tune_src is p and PT.signature_of(s1) == sig == PT.signature_of(s2)
    assert PT.signature_of(PF.SELL.from_csr(p)) is None       # hand-built: cold
    r = RC.build("powerlaw")
    assert RT.signature_of(ref_convert_cached(r, "sell", {"C": 8, "sigma": 64})) == sig


def test_same_candidates_save_equal_json_and_cross_load(tmp_path, powerlaw):
    r, p = powerlaw
    rdb, pdb = RT.TuneDB(), PT.TuneDB()
    rdb.record(r, chip=RCHIP, candidates=_cands(RT, POWERLAW), matrix_name="powerlaw")
    pdb.record(p, chip=CHIP, candidates=_cands(PT, POWERLAW), matrix_name="powerlaw",
               device="cpu")
    rp, pp = rdb.save(tmp_path / "ref.json"), pdb.save(tmp_path / "port.json")
    # the same document once the backend names are mapped
    want = rp.read_text()
    for a, b in BACKEND.items():
        want = want.replace(f'"backend": "{a}"', f'"backend": "{b}"')
    assert pp.read_text() == want
    assert pdb.token != PT.TuneDB().token
    # each package reads the other's file
    assert PT.TuneDB.load(rp).entries == rdb.entries
    assert RT.TuneDB.load(pp).entries == pdb.entries
    # saving again is byte-identical
    text = pp.read_text()
    PT.TuneDB.load(pp).save(pp)
    assert pp.read_text() == text


def test_warm_format_pick_equals_the_references(powerlaw):
    r, p = powerlaw
    rdb, pdb = RT.TuneDB(), PT.TuneDB()
    rdb.record(r, chip=RCHIP, candidates=_cands(RT, POWERLAW))
    pdb.record(p, chip=CHIP, candidates=_cands(PT, POWERLAW), device="cpu")
    for allowed in (None, ("csr", "jds"), ("jds",)):
        want = RPM.select_format(r, chip=RCHIP, tuning=rdb, allowed=allowed)
        got = PM.select_format(p, chip=CHIP, tuning=pdb, allowed=allowed, device="cpu")
        assert (got.format, got.convert_kwargs, got.predicted_time_s, got.source) == \
            (want.format, want.convert_kwargs, want.predicted_time_s, want.source)
        assert got.source == "measured"
    assert pdb.lookup_format(p, chip=CHIP, device="cpu") == \
        rdb.lookup_format(r, chip=RCHIP)


def test_warm_backend_pick_equals_the_references(powerlaw):
    r, p = powerlaw
    rdb, pdb = RT.TuneDB(), PT.TuneDB()
    rdb.record(r, chip=RCHIP, candidates=[
        RT.Candidate("csr", "loop_reference", 1e-7), RT.Candidate("csr", "xla", 2e-5)])
    pdb.record(p, chip=CHIP, candidates=[
        PT.Candidate("csr", "loop_reference", 1e-7), PT.Candidate("csr", "torch", 2e-5)],
        device="cpu")
    want = RR.select_backend(r, "csr", "spmv", RR.KernelContext(chip=RCHIP, tuning=rdb))
    got = PR.select_backend(p, "csr", "spmv",
                            PR.KernelContext(device=CPU, chip=CHIP, tuning=pdb))
    assert got == want == ("loop_reference", {"loop_reference": 1e-7})
    # another DB (or none) never reuses the memoized warm choice
    assert PR.select_backend(p, "csr", "spmv", PR.KernelContext(device=CPU, chip=CHIP))[0] \
        == "torch"
    # only SpMV is recorded: SpMM stays cold
    assert pdb.lookup_backend(p, "csr", "spmm", chip=CHIP, device="cpu") is None


def test_plan_compile_warm_vs_cold(tmp_path, powerlaw):
    _, p = powerlaw
    m = PF.CSR(p.row_ptr.clone(), p.col_idx.clone(), p.val.clone(), p.shape)
    db = PT.TuneDB()
    db.record(m, chip=CHIP, candidates=_cands(PT, [("jds", 1e-6, {}, None)]), device="cpu")
    cold = SpMVPlan.compile(m, PlanConfig(format="auto", chip=CHIP, device="cpu"))
    warm = SpMVPlan.compile(m, PlanConfig(format="auto", chip=CHIP, device="cpu", tuning=db))
    assert cold.report.format != "jds" and warm.report.format == "jds"
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(m.shape[1]))
    assert float((warm(x) - cold(x)).abs().max() / cold(x).abs().max()) <= 1e-5
    # tuning= also takes a path, parsed once until the file changes
    path = db.save(tmp_path / "db.json")
    from_path = SpMVPlan.compile(m, PlanConfig(format="auto", chip=CHIP, device="cpu",
                                               tuning=str(path)))
    assert from_path.report.format == "jds"
    assert PT.open_db(str(path)) is PT.open_db(path) and PT.open_db(db) is db
    assert PT.open_db(None) is None


@pytest.mark.parametrize("payload", [
    "{ not json at all",
    '{"version": 1, "entries": {"k": {}}',
    '[1, 2, 3]',
    '{"version": 999, "entries": {}}',
    '{"version": 1, "entries": [], "efficiency": {}}',
])
def test_corrupt_db_warns_and_degrades_to_cold(tmp_path, powerlaw, payload):
    r, p = powerlaw
    path = tmp_path / "tunedb.json"
    path.write_text(payload)
    with pytest.warns(RT.TuneDBWarning):
        rdb = RT.TuneDB.load(path)
    with pytest.warns(PT.TuneDBWarning):
        pdb = PT.TuneDB.load(path)
    assert len(pdb) == len(rdb) == 0
    cold = PM.select_format(p, chip=CHIP, device="cpu")
    warm = PM.select_format(p, chip=CHIP, tuning=pdb, device="cpu")
    want = RPM.select_format(r, chip=RCHIP, tuning=rdb)
    assert (warm.format, warm.source, warm.predicted_time_s) == \
        (cold.format, "model", cold.predicted_time_s)
    assert warm.format == want.format and want.source == "model"


def test_missing_file_is_an_empty_db_without_warning(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        db = PT.TuneDB.load(tmp_path / "nope.json")
    assert len(db) == 0 and db.path == tmp_path / "nope.json"
    with pytest.raises(ValueError, match="no path"):
        PT.TuneDB().save()


def test_stale_and_foreign_entries_fall_back_to_cold(powerlaw):
    r, p = powerlaw
    cold = PM.select_format(p, chip=CHIP, device="cpu")
    woodcrest = ChipSpec(RHW.WOODCREST.name, 1e10, 5e9, 1e10)
    cases = {
        # another chip family (a cpu-family record priced for a tpu chip)
        "family": dict(chip=woodcrest, candidates=_cands(PT, POWERLAW), platform="cpu"),
        # the card's record on the host: another platform
        "platform": dict(chip=CHIP, candidates=_cands(PT, POWERLAW), platform="cuda"),
        # the reference's backend names: no such port entry
        "foreign_backend": dict(chip=CHIP, platform="cpu", candidates=[
            dataclasses.asdict(c) for c in _cands(RT, POWERLAW)]),
        # a kernel that cannot run on the host
        "cuda_on_host": dict(chip=CHIP, candidates=_cands(PT, POWERLAW, "pallas"),
                             platform="cpu"),
        # a format that no longer exists
        "removed": dict(chip=CHIP, candidates=[PT.Candidate("zzz", "torch", 1e-6)],
                        platform="cpu"),
    }
    for name, kw in cases.items():
        db = PT.TuneDB()
        assert db.record(p, **kw) is not None, name
        assert db.lookup(p, chip=CHIP, device="cpu") is None, name
        assert db.lookup_format(p, chip=CHIP, device="cpu") is None, name
        got = PM.select_format(p, chip=CHIP, tuning=db, device="cpu")
        assert (got.format, got.source) == (cold.format, "model"), name
    # the reference ignores the same foreign-family and removed records
    rdb = RT.TuneDB()
    rdb.record(r, chip=RHW.WOODCREST, candidates=_cands(RT, POWERLAW))
    assert RPM.select_format(r, chip=RCHIP, tuning=rdb).source == "model"
    # another value dtype is another key
    db = PT.TuneDB()
    db.record(p, chip=CHIP, candidates=_cands(PT, POWERLAW), device="cpu")
    assert db.raw_lookup(p, chip=CHIP, device="cpu", value_dtype="bf16") is None
    assert db.raw_lookup(p, chip=CHIP, device="cpu") is not None
    assert db.lookup(p, chip=CHIP, device="cpu")["best"]["format"] == "sell"
    # nothing to record
    assert db.record(PF.SELL.from_csr(p), chip=CHIP, candidates=_cands(PT, POWERLAW),
                     device="cpu") is None
    assert db.record(p, chip=CHIP, candidates=[PT.Candidate("csr", "torch", 0.0)],
                     device="cpu") is None


def test_stale_winner_falls_through_to_the_next_fresh_candidate(powerlaw):
    _, p = powerlaw
    db = PT.TuneDB()
    db.record(p, chip=CHIP, device="cpu", candidates=[
        PT.Candidate("sell", "cuda", 1e-6, convert_kwargs={"C": 8, "sigma": 64}),
        PT.Candidate("csr", "torch", 3e-5)])
    assert db.entries and next(iter(db.entries.values()))["best"]["backend"] == "cuda"
    assert db.lookup(p, chip=CHIP, device="cpu") is None      # cuda cannot run here
    fmt, _, times = db.lookup_format(p, chip=CHIP, device="cpu")
    assert fmt == "csr" and "sell" not in times
    assert db.lookup_backend(p, "sell", "spmv", chip=CHIP, device="cpu") is None


def test_efficiency_refit_matches_reference(powerlaw):
    r, p = powerlaw
    spec = [("sell", 2e-4, {}, 1e-4), ("jds", 1e-5, {}, 1e-3), ("csr", 1.0, {}, 1e-4),
            ("ell", 3e-5, {}, 2e-5)]
    rdb, pdb = RT.TuneDB(), PT.TuneDB()
    rdb.record(r, chip=RCHIP, candidates=_cands(RT, spec))
    pdb.record(p, chip=CHIP, candidates=_cands(PT, spec), device="cpu")
    rdb.record(RC.build("stripe"), chip=RCHIP, candidates=_cands(RT, spec[:1]))
    pdb.record(PC.build("stripe"), chip=CHIP, candidates=_cands(PT, spec[:1]), device="cpu")
    want = RPM.fit_efficiency_from_db(rdb, chip=RCHIP)
    got = PM.fit_efficiency_from_db(pdb, chip=CHIP)
    assert got.keys() == want.keys()
    assert all(abs(got[k] - want[k]) <= 1e-12 for k in want)
    assert got["jds"] == 1.5 and got["csr"] == 0.01 and got["sell"] == pytest.approx(0.5)
    # another family sees none of these records: the committed table
    assert PM.fit_efficiency_from_db(pdb, chip=H100) == PM.EXEC_EFFICIENCY["h100"]
    assert PM.fit_efficiency_from_db(pdb, family="h100") == PM.EXEC_EFFICIENCY["h100"]
    # a persisted fit refines the cold ranking (as in the reference)
    assert pdb.efficiency_for(CHIP) is None
    pdb.efficiency[PM.chip_family(CHIP)] = got
    rdb.efficiency[RPM.chip_family(RCHIP)] = want
    m = PC.build("random_uniform")
    a = PM.select_format(m, chip=CHIP, tuning=pdb, device="cpu")
    b = RPM.select_format(RC.build("random_uniform"), chip=RCHIP, tuning=rdb)
    assert a.source == b.source == "model" and a.format == b.format
    assert a.predicted_time_s == PM.select_format(m, chip=CHIP, efficiency=got,
                                                  device="cpu").predicted_time_s


def test_drift_table_matches_reference(powerlaw):
    r, p = powerlaw
    rdb, pdb = RT.TuneDB(), PT.TuneDB()
    rdb.record(r, chip=RCHIP, candidates=_cands(RT, POWERLAW), matrix_name="pl")
    pdb.record(p, chip=CHIP, candidates=_cands(PT, POWERLAW), matrix_name="pl",
               device="cpu")
    want = RT.drift_table(rdb)
    for row in want:
        row["backend"] = BACKEND[row["backend"]]
    assert PT.drift_table(pdb) == want


def _cuda_accepts(monkeypatch):
    """Make the csr cuda entry's probe accept on the host (its kernel is
    never built here: only the selection is under test)."""
    key = ("csr", "spmv", "cuda")
    entry = PR.get(*key)
    monkeypatch.setitem(PR._TABLE, key, dataclasses.replace(
        entry, probe=lambda m, ctx: PR.CAP_OK))


def test_a_runnable_cuda_entry_beats_any_record(monkeypatch, powerlaw):
    """The DB decides only among the entries left when no cuda entry can
    run: every CUDA kernel beats its plain version on the card, so a record
    naming torch over a runnable kernel is stale or foreign."""
    _, p = powerlaw
    m = PF.CSR(p.row_ptr.clone(), p.col_idx.clone(), p.val.clone(), p.shape)
    db = PT.TuneDB()
    db.record(m, chip=CHIP, device="cpu", candidates=[
        PT.Candidate("csr", "torch", 1e-7), PT.Candidate("csr", "cuda", 1e-5)])
    ctx = PR.KernelContext(device=CPU, chip=CHIP, tuning=db)
    assert PR.select_backend(m, "csr", "spmv", ctx)[0] == "torch"
    _cuda_accepts(monkeypatch)
    fresh = PF.CSR(p.row_ptr.clone(), p.col_idx.clone(), p.val.clone(), p.shape)
    be, costs = PR.select_backend(fresh, "csr", "spmv", ctx)
    assert be == "cuda" and set(costs) == {"torch", "cuda"}
