"""The port's CUDA side as far as a machine without a card can check it: no
silent CPU, the kernel sources and their build command, import hygiene.
The kernels themselves run in ``test_torch_on_card.py`` and ``chip_smoke.py``."""
import pytest

pytest.importorskip("jax")

import ast  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from _torch_parity import port_matrix  # noqa: E402
from repro_torch.core.eigensolver import lanczos  # noqa: E402
from repro_torch.core.plan import SpMVPlan  # noqa: E402
from repro_torch.core.planconfig import PlanConfig  # noqa: E402
from repro_torch.kernels import cuda_build as CB  # noqa: E402
from repro_torch.utils.hw import default_device  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_when_cuda_is_absent(no_cuda):
    m = port_matrix("exact3")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpMVPlan.compile(m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpMVPlan.compile(m, PlanConfig(format="csr", device="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lanczos(m, m.shape[0], m=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lanczos(lambda x: x, m.shape[0], m=4)
    assert default_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", CB.KERNELS)
def test_kernel_source_present_with_its_note(name):
    src = CB.source_path(name).read_text()
    head = src.split("#include")[0]
    assert "Replaces: repro/kernels/" in head
    assert "Bound:" in head and "Design:" in head
    assert f'extern "C" int {name}(' in src
    assert "cudaGetLastError()" in src


def test_build_command_is_nvcc_for_sm_90a(tmp_path):
    cmd = CB.nvcc_command("/usr/local/cuda/bin/nvcc", "sell_spmv", tmp_path / "x.so")
    assert Path(cmd[0]).name == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/sell_spmv.cu")
    # the library name follows the sources: an edit rebuilds
    assert CB.library_path("sell_spmv") != CB.library_path("dia_spmv")
    assert CB.library_path("sell_spmv").parent == CB.BUILD_DIR


def test_build_without_nvcc_names_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(CB, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        CB.build_kernels()


def _imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


def test_port_and_chip_smoke_import_nothing_of_the_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{f}: {mod}"


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, shutil.copy(REPO / "chip_smoke.py", tmp_path))):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
