"""The port's dry-run and roofline tools (``repro_torch.launch.{dryrun,
roofline,hillclimb}`` and the rest of ``repro_torch.utils.hw``) against the
reference's.

* ``analytic_hbm_bytes_per_device`` equals the reference's to 1e-12 for
  every arch x shape on the (16, 16) and (2, 16, 16) meshes, and for each
  hill-climb iteration on its cell; where the reference's dtype test
  misprices the AdamW state (f32 read as 2 bytes), the corrected formula.
* ``roofline`` / ``analyse_record`` / ``table_from_jsonl`` on synthetic
  records, priced on a ``ChipSpec`` built in the test from the reference's
  ``TPU_V5E`` values: the reference's rows and text, with the port's renames
  (the XLA byte column is the counted one; the notes name the card's units).
* ``CELLS``, ``ITERS`` and ``_depth_override`` equal the reference's.
* ``run_cell`` / ``extrapolate_depth`` on reduced configs: the depth fit
  reproduces the full-depth count, the skip reasons are the reference's,
  and a count the port does not make is ``None`` with a reason, never 0.
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.launch import roofline as RR  # noqa: E402
from repro.utils import hw as RHW  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch import hillclimb as HILL  # noqa: E402
from repro_torch.launch import roofline as PR  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import registry as REG  # noqa: E402
from repro_torch.utils import hw as PHW  # noqa: E402

#: the cell each hill-climb iteration was written for (the reference's
#: comments group them: H1 qwen3, H2 jamba, H3 glm4)
ITER_CELL = {
    "baseline": "qwen3_train", "dp_only": "qwen3_train",
    "dp_only_remat_dots": "qwen3_train", "dp_only_remat_none": "qwen3_train",
    "moe2d": "jamba_train", "moe2d_remat_dots": "jamba_train",
    "dispatch_g1": "jamba_train", "grouped_dispatch": "jamba_train",
    "grouped_remat_dots": "jamba_train", "gather_w": "jamba_train",
    "gather_w_dots": "jamba_train", "aligned_ssm": "jamba_train",
    "aligned_ssm_dots": "jamba_train", "seq_kv": "glm4_decode",
    "seq_kv_q8": "glm4_decode", "seq_kv_bf16w": "glm4_decode",
    "seq_kv_bf16w_q8": "glm4_decode", "cache_q8": "deepseek_decode",
}


@pytest.fixture(scope="module")
def ref_hillclimb():
    """The reference's hillclimb module.  Its import sets ``XLA_FLAGS`` for
    512 placeholder devices; the variable is put back as it was."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as RD
    from repro.launch import hillclimb as RH
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return RH, RD


def _ref_corrected(arch, shape, n, overrides=None):
    """The reference's value with its AdamW term repriced at the real
    itemsizes: it reads ``str(dtype).endswith("32")`` (False for
    ``jnp.float32``), so it takes f32 parameters and opt state as 2 bytes."""
    from repro.launch import roofline as R
    from repro.models.registry import Model, get_config
    from repro.utils.tree import param_bytes
    ref = R.analytic_hbm_bytes_per_device(arch, shape, n, overrides=overrides)
    if SHAPES[shape].kind != "train":
        return ref
    cfg = get_config(arch, **_ref_overrides(overrides))
    shapes = Model(cfg).param_shapes()
    P = param_bytes(shapes)
    pb_ref = np.dtype(np.float32 if str(cfg.param_dtype).endswith("32") else np.float16).itemsize
    oi_ref = 4 if str(cfg.opt_dtype).endswith("float32") else 2
    N = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    oi = np.dtype(cfg.opt_dtype).itemsize
    return ref + 2 * (3 * N * oi / n - 3 * (P / pb_ref) * oi_ref / n)


def _ref_overrides(ov) -> dict:
    """The config overrides the reference's ``analytic_hbm_bytes_per_device``
    applies (its dtype reading and key filter)."""
    import jax.numpy as jnp
    out = {}
    for k, v in (ov or {}).items():
        if k in ("param_dtype", "cache_dtype", "opt_dtype"):
            s = str(v)
            v = (jnp.float8_e4m3fn if "float8" in s or s == "f8" else
                 jnp.bfloat16 if "bf16" in s or "bfloat16" in s else jnp.float32)
        if k in ("param_dtype", "cache_dtype", "opt_dtype", "remat", "shard_profile",
                 "kv_seq_shard_threshold", "moe_dispatch_groups"):
            out[k] = int(v) if k == "kv_seq_shard_threshold" else v
    return out


@pytest.mark.parametrize("n_devices", (256, 512), ids=("16x16", "2x16x16"))
@pytest.mark.parametrize("shape", tuple(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_hbm_bytes_match_reference(arch, shape, n_devices):
    want = RR.analytic_hbm_bytes_per_device(arch, shape, n_devices)
    got = PR.analytic_hbm_bytes_per_device(arch, shape, n_devices)
    assert abs(got / want - 1) <= 1e-12
    assert abs(got / _ref_corrected(arch, shape, n_devices) - 1) <= 1e-12


@pytest.mark.parametrize("it", tuple(ITER_CELL))
def test_analytic_hbm_bytes_of_each_iteration(it):
    arch, shape = HILL.CELLS[ITER_CELL[it]]
    ov = HILL.ITERS[it]
    got = PR.analytic_hbm_bytes_per_device(arch, shape, 256, overrides=ov)
    assert abs(got / _ref_corrected(arch, shape, 256, ov) - 1) <= 1e-12
    assert abs(got / RR.analytic_hbm_bytes_per_device(arch, shape, 256, overrides=ov)
               - 1) <= 1e-12


@pytest.mark.parametrize("ov", ({"param_dtype": "bf16"}, {"opt_dtype": "bf16"}))
def test_the_dtype_fault_is_repriced(ov):
    """Parameters and AdamW state of different widths: the reference prices
    the opt state at 2 bytes either way; the port at its dtype."""
    got = PR.analytic_hbm_bytes_per_device("qwen3-0.6b", "train_4k", 256, overrides=ov)
    ref = RR.analytic_hbm_bytes_per_device("qwen3-0.6b", "train_4k", 256, overrides=ov)
    assert got != ref
    assert abs(got / _ref_corrected("qwen3-0.6b", "train_4k", 256, ov) - 1) <= 1e-12


# --- utils.hw ----------------------------------------------------------------


def _v5e_priced() -> PHW.ChipSpec:
    """A port ChipSpec holding the reference's TPU_V5E values (read here;
    the port holds no TPU constant)."""
    t = RHW.TPU_V5E
    return PHW.ChipSpec(t.name, t.peak_flops_fp32, t.peak_flops_fp32, t.hbm_bytes_per_s,
                        peak_flops_bf16=t.peak_flops_bf16, hbm_bytes=t.hbm_bytes,
                        link_bytes_per_s=t.ici_bytes_per_s_per_link, links=t.ici_links)


@pytest.mark.parametrize("links", (None, 4))
@pytest.mark.parametrize("case", ((3e15, 2e12, 5e10, 256), (1e12, 8e12, 0.0, 16),
                                  (5e14, 1e11, 9e12, 512)))
def test_roofline_terms_match_reference(case, links):
    flops, hbm, coll, chips = case
    r = RHW.roofline(flops, hbm, coll, chips, collective_links=links)
    p = PHW.roofline(flops, hbm, coll, chips, chip=_v5e_priced(), collective_links=links)
    rd, pd = r.as_dict(), p.as_dict()
    assert pd.pop("peak_flops_bf16") == RHW.TPU_V5E.peak_flops_bf16
    assert pd == rd
    assert (p.serial_s, p.critical_s, p.bound) == (r.serial_s, r.critical_s, r.bound)
    assert p.mfu_bound(0.4 * flops) == r.mfu_bound(0.4 * flops)


def test_mfu_bound_divides_by_the_priced_chip():
    """The reference divides by TPU_V5E's peak whatever the chip priced; the
    port by the terms' own chip."""
    p = PHW.roofline(1e15, 1e12, 0.0, 8)
    assert p.mfu_bound(1e15) == pytest.approx(1e15 / p.critical_s / (8 * 989e12))
    import dataclasses
    r = RHW.roofline(1e15, 1e12, 0.0, 8, chip=dataclasses.replace(
        RHW.TPU_V5E, name="other", peak_flops_bf16=1e14))
    assert r.mfu_bound(1e15) == 1e15 / r.critical_s / (8 * RHW.TPU_V5E.peak_flops_bf16)


def test_flops_per_token_and_chips_match_reference():
    for n in (0.6e9, 2.45e9, 9.4e10):
        assert PHW.model_flops_per_token(n) == RHW.model_flops_per_token(n)
        assert PHW.decode_flops_per_token(n) == RHW.decode_flops_per_token(n)
    for name in ("woodcrest", "shanghai", "nehalem"):
        r, p = RHW.CHIPS[name], PHW.CHIPS[name]
        assert (p.peak_flops_bf16, p.peak_flops_fp32, p.hbm_bytes_per_s, p.hbm_bytes,
                p.link_bytes_per_s, p.links) == (
            r.peak_flops_bf16, r.peak_flops_fp32, r.hbm_bytes_per_s, r.hbm_bytes,
            r.ici_bytes_per_s_per_link, r.ici_links)
    h = PHW.H100
    assert (h.peak_flops_bf16, h.hbm_bytes, h.hbm_bytes_per_s, h.links,
            h.link_bytes_per_s * h.links) == (989e12, 80e9, 3.35e12, 18, 450e9)
    assert not h.measured and "tpu" not in " ".join(PHW.CHIPS)


# --- launch.roofline on synthetic records -------------------------------------

_RENAME = {"bytes_dev_xla": "bytes_dev_counted", "memory_s_xla": "memory_s_counted"}
_NOTE = dict(zip(RR._NOTES.values(), PR._NOTES.values()))


def _records():
    """Reference-keyed records and the same records under the port's keys."""
    rng = np.random.default_rng(7)
    recs = []
    for arch, shape in (("qwen3-0.6b", "train_4k"), ("glm4-9b", "decode_32k"),
                        ("deepseek-v2-lite-16b", "prefill_32k"), ("mamba2-2.7b", "long_500k"),
                        ("jamba-1.5-large-398b", "train_4k")):
        for mesh, n in (("16x16", 256), ("2x16x16", 512)):
            rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok", "n_devices": n,
                   "flops_per_device": float(rng.uniform(1e12, 1e15)),
                   "bytes_per_device": float(rng.uniform(1e9, 1e12)),
                   "collective_bytes_per_device": float(rng.uniform(0, 1e11)),
                   "model_flops": float(rng.uniform(1e14, 1e17))}
            if arch != "glm4-9b":
                rec["jaxpr_flops_global"] = float(rng.uniform(1e15, 1e18))
            if arch == "qwen3-0.6b":
                rec["extrap"] = {"bytes_per_device_extrap": rec["bytes_per_device"] * 3,
                                 "coll_per_device_extrap": rec["collective_bytes_per_device"] / 2}
            if arch == "jamba-1.5-large-398b":
                rec["extra_cfg"] = {"moe_dispatch_groups": "16", "remat": "dots"}
            recs.append(rec)
    recs.append({"arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "16x16",
                 "status": "skipped", "reason": "long_500k needs sub-quadratic attention"})
    recs.append({"arch": "gemma-7b", "shape": "train_4k", "mesh": "16x16",
                 "status": "error", "error": "RuntimeError: boom"})
    ports = []
    for rec in recs:
        p = dict(rec)
        if "jaxpr_flops_global" in p:
            p["op_flops_global"] = p.pop("jaxpr_flops_global")
        ports.append(p)
    return recs, ports


def test_analyse_record_matches_reference():
    chip = _v5e_priced()
    recs, ports = _records()
    for r, p in zip(recs, ports):
        want, got = RR.analyse_record(r), PR.analyse_record(p, chip)
        if want is None:
            assert got is None
            continue
        w = {_RENAME.get(k, k): v for k, v in vars(want).items()}
        w["note"] = _NOTE[w["note"]]
        assert vars(got) == w


def test_table_from_jsonl_matches_reference(tmp_path):
    recs, ports = _records()
    rp, pp = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    rp.write_text("".join(json.dumps(r) + "\n" for r in recs))
    pp.write_text("".join(json.dumps(r) + "\n" for r in ports))
    for mesh in ("16x16", "2x16x16", None):
        want = RR.table_from_jsonl(str(rp), mesh_filter=mesh)
        want = want.replace("memory ms (XLA)", "memory ms (counted)")
        for a, b in _NOTE.items():
            want = want.replace(a, b)
        assert PR.table_from_jsonl(str(pp), mesh_filter=mesh, chip=_v5e_priced()) == want


def test_missing_counts_stay_missing():
    rec = {"arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "16x16", "status": "ok",
           "n_devices": 256, "flops_per_device": 1e13, "op_flops_global": 2.56e15,
           "bytes_per_device": None, "collective_bytes_per_device": None,
           "model_flops": 1e15}
    row = PR.analyse_record(rec)
    assert row.collective_s is None and row.memory_s_counted is None
    assert row.bound in ("compute", "memory")
    assert "| n/c | n/c |" in row.md()


# --- launch.hillclimb / launch.dryrun -----------------------------------------


def test_cells_and_iters_match_reference(ref_hillclimb):
    RH, _ = ref_hillclimb
    assert HILL.CELLS == RH.CELLS and HILL.ITERS == RH.ITERS
    assert set(ITER_CELL) == set(HILL.ITERS)
    for it, ov in HILL.ITERS.items():
        r, p = RH.resolve_overrides(ov), HILL.resolve_overrides(ov)
        assert set(r) == set(p)
        for k in r:
            if k.endswith("_dtype"):
                assert str(p[k]).removeprefix("torch.") == np.dtype(r[k]).name
            else:
                assert p[k] == r[k]


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_override_matches_reference(ref_hillclimb, arch):
    from repro.models.registry import get_config as ref_get
    _, RD = ref_hillclimb
    for n in (1, 2, 5):
        assert DRY._depth_override(REG.get_config(arch), n) == RD._depth_override(
            ref_get(arch), n)


@pytest.fixture
def small(monkeypatch):
    """Every config reduced (1024-token attention chunks, remat kept), for
    the meta runs of ``launch.dryrun``."""
    full = REG.get_config

    def get(name, **ov):
        cfg = full(name, **ov)
        return reduced(cfg, remat=cfg.remat, q_chunk=1024, k_chunk=1024,
                       **{k: v for k, v in ov.items() if k in ("n_layers", "n_enc_layers")})

    for mod in (REG, DRY, PR):
        monkeypatch.setattr(mod, "get_config", get)
    return get


def test_run_cell_dp_only_train(small):
    rec = DRY.run_cell("qwen3-0.6b", "train_4k", multi_pod=False, verbose=False,
                       extra_cfg={"shard_profile": "dp_only"}, extrapolate=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 256 and rec["local_batch"] == 1
    assert rec["flops_per_device"] == rec["op_flops_global"] / 256
    assert rec["bytes_per_device"] > 0 and rec["launches"] == 0
    assert rec["collective_bytes_per_device"] is None and rec["collective_reason"]
    assert rec["memory"]["temp_bytes"] is None and rec["memory"]["temp_reason"]
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["output_bytes"] > 0
    ex = rec["extrap"]
    assert ex["flops_per_device_extrap"] == rec["flops_per_device"]
    assert ex["bytes_per_device_extrap"] == rec["bytes_per_device"]
    assert ex["coll_per_device_extrap"] is None
    cfg = small("qwen3-0.6b")
    n_active = REG.Model(cfg).active_params()
    assert rec["model_flops"] == 6.0 * n_active * 4096 * 256
    row = PR.analyse_record(rec)
    assert row.memory_s_counted > 0 and row.collective_s is None


@pytest.mark.parametrize("arch,shape", (("deepseek-v2-lite-16b", "decode_32k"),
                                        ("mamba2-2.7b", "decode_32k"),
                                        ("whisper-tiny", "decode_32k"),
                                        ("jamba-1.5-large-398b", "long_500k")))
def test_depth_fit_reproduces_the_count(small, arch, shape):
    rec = DRY.run_cell(arch, shape, multi_pod=False, verbose=False, extrapolate=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["extrap"]["flops_per_device_extrap"] == rec["flops_per_device"]
    assert rec["bytes_per_device"] is None and rec["bytes_reason"]
    assert rec["extrap"]["bytes_per_device_extrap"] is None


def test_skip_reasons_match_reference():
    from repro.configs import shape_applicable as ref_applicable
    from repro.models.registry import get_config as ref_get
    skipped = 0
    for arch in ARCHS:
        ok, why = ref_applicable(ref_get(arch), "long_500k")
        if not ok:
            skipped += 1
            assert DRY.run_cell(arch, "long_500k", multi_pod=False, verbose=False) == {
                "arch": arch, "shape": "long_500k", "mesh": "16x16", "status": "skipped",
                "reason": why}
    assert skipped == 8


def test_local_shards_follow_the_specs():
    mesh = make_production_mesh()
    P = DRY.shrules.P
    assert DRY.local_shape((256, 4096), P(("data", "model"), None), mesh) == (1, 4096)
    assert DRY.local_shape((24, 1024), P("model", None), mesh) == (2, 1024)
    assert DRY.local_shape((8,), P(), mesh) == (8,)
    model = REG.Model(REG.get_config("qwen3-0.6b"))
    specs = DRY.step_specs(model, "train_4k", mesh)
    b, why = DRY.local_batch(model, "train_4k", specs, mesh)
    assert b is None and "parameter" in why
    model = REG.Model(REG.get_config("qwen3-0.6b", shard_profile="dp_only"))
    specs = DRY.step_specs(model, "train_4k", mesh)
    assert DRY.local_batch(model, "train_4k", specs, mesh) == (1, "")
