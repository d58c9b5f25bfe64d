"""Functions of modules ported earlier that the port lacked, each held
against the reference: ``power_iteration``, ``compile_plan``, the
registry's introspection and CLI, the paper's three machines and the
Holstein experiment config."""
import pytest

pytest.importorskip("jax")

import dataclasses  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import to_port, x64  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core import perfmodel as PPM  # noqa: E402
from repro_torch.core.eigensolver import power_iteration  # noqa: E402
from repro_torch.core.plan import SpMVPlan, compile_plan  # noqa: E402
from repro_torch.core.planconfig import PlanConfig  # noqa: E402
from repro_torch.kernels import registry as R  # noqa: E402
from repro_torch.utils import hw as PHW  # noqa: E402

CPU = PlanConfig(device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gapped_csr(n: int = 64):
    """Reference CSR of a dense symmetric matrix with |lambda|: 10, 5, then
    at most 4 (a ratio of 0.5 between the two largest)."""
    from repro.core import formats as RF
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([[10.0, -5.0], np.linspace(-4.0, 4.0, n - 2)])
    return RF.CSR.from_dense((q * lam) @ q.T)


def test_power_iteration_matches_reference():
    import jax.numpy as jnp
    from repro.core.eigensolver import power_iteration as ref_power
    from repro.core.plan import PlanConfig as RefConfig
    from repro.core.plan import SpMVPlan as RefPlan
    r = _gapped_csr()
    n = r.shape[0]
    with x64():
        want = ref_power(RefPlan.compile(r, RefConfig(format="csr", backend="xla")), n,
                         iters=200, dtype=jnp.float64)
    got = power_iteration(SpMVPlan.compile(to_port(r), CPU.replace(format="csr")), n,
                          iters=200)
    assert abs(got - want) <= 1e-8 * abs(want)
    assert abs(got - 10.0) <= 1e-8 * 10.0


def test_power_iteration_takes_a_container_on_the_host():
    r = _gapped_csr()
    lam = power_iteration(to_port(r), r.shape[0], device="cpu")
    assert lam == pytest.approx(10.0, rel=1e-8)


def test_compile_plan_is_the_compile_alias():
    assert compile_plan is SpMVPlan.compile
    m = PF.CSR.from_dense(np.eye(8))
    plan = compile_plan(m, CPU)
    assert isinstance(plan, SpMVPlan) and plan is SpMVPlan.compile(m, CPU)


def test_table_rows_cover_every_registered_entry():
    rows = R.table_rows()
    keys = {(r["format"], r["op"], r["backend"]) for r in rows}
    assert len(keys) == len(rows) == len(R.entries())
    assert keys == {e.key for e in R.entries()}
    assert {"torch", "cuda", "loop_reference"} <= {r["backend"] for r in rows}
    assert {"slab_ell", "slab_sell"} <= {r["format"] for r in rows}
    on_cpu = R.table_rows(device="cpu")
    assert all(not r["available"] for r in on_cpu if r["backend"] == "cuda")
    assert all(r["available"] for r in on_cpu if r["backend"] != "cuda")
    assert all(r["value_dtypes"] == tuple(PF.VALUE_DTYPES) for r in rows)


def test_format_table_markdown_has_its_header():
    md = R.format_table(markdown=True, device="cpu").splitlines()
    assert md[0].startswith("|") and "dtypes" in md[0] and "backend" in md[0]
    assert set(md[1]) <= {"|", "-", " "}
    assert len(md) == 2 + len(R.entries())
    assert any("| cuda" in ln for ln in md) and any("slab_sell" in ln for ln in md)


def test_registry_main_lists_the_table(capsys):
    assert R.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert len(out.splitlines()) == 1 + len(R.entries()) and "cuda" in out
    assert R.main(["--markdown", "--device", "cpu"]) == 0
    assert "### Kernel registry" in capsys.readouterr().out


def test_registry_module_cli_delegates_to_the_canonical_table():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.kernels.registry", "--list"],
                         capture_output=True, text=True, env=env, timeout=120, check=True)
    lines = out.stdout.splitlines()
    assert len(lines) == 1 + len(R.entries())
    assert any(ln.split()[:3] == ["csr", "spmv", "cuda"] for ln in lines)


def test_capabilities_and_build_best_match_select_backend():
    m = to_port(_gapped_csr(32))
    ctx = R.KernelContext(device="cpu")
    caps = R.capabilities(m, "csr", "spmv", ctx)
    assert set(caps) == {e.backend for e in R.entries("csr", "spmv")}
    assert not caps["cuda"].ok and caps["torch"].ok and caps["loop_reference"].ok
    best = R.build_best(m, "csr", "spmv", ctx)
    backend, _ = R.select_backend(m, "csr", "spmv", ctx)
    want = R.build(m, "csr", "spmv", backend, ctx)
    assert backend == "torch" and best.label == want.label
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(32))
    assert torch.equal(best.fn(x), want.fn(x))


@pytest.mark.parametrize("name", ("WOODCREST", "SHANGHAI", "NEHALEM"))
def test_paper_machines_price_like_the_reference(name):
    from repro.core import perfmodel as RPM
    from repro.utils import hw as RHW
    port, ref = getattr(PHW, name), getattr(RHW, name)
    assert (port.name, port.peak_flops_fp32, port.hbm_bytes_per_s) == \
        (ref.name, ref.peak_flops_fp32, ref.hbm_bytes_per_s)
    assert port.peak_flops_fp64 == ref.peak_flops_fp32
    assert PHW.CHIPS[port.name] is port and PPM.chip_family(port) == "cpu"
    b = PPM.balance_csr(PPM.PAPER_FP64, 14)
    assert PPM.predict("csr", b, 10**6, chip=port).time_s == \
        RPM.predict("csr", RPM.balance_csr(RPM.PAPER_FP64, 14), 10**6, chip=ref).time_s


def test_paper_machines_pricing_ratio():
    b = PPM.balance_csr(PPM.PAPER_FP64, 14)
    t_wood = PPM.predict("csr", b, 10**6, chip=PHW.WOODCREST).time_s
    t_neh = PPM.predict("csr", b, 10**6, chip=PHW.NEHALEM).time_s
    assert t_wood / t_neh == pytest.approx(
        PHW.NEHALEM.hbm_bytes_per_s / PHW.WOODCREST.hbm_bytes_per_s, rel=0.01)
    assert set(PHW.CHIPS) == {"h100_sxm", "woodcrest", "shanghai", "nehalem"}


@pytest.mark.parametrize("preset", ("paper_scale", "bench_scale", "smoke_scale"))
def test_holstein_config_equals_reference(preset):
    from repro.configs import holstein as RH
    from repro_torch.configs import holstein as PH
    got, want = getattr(PH, preset)(), getattr(RH, preset)()
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
