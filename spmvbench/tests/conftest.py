"""Shared set-up of the benchmark's tests: the repository's root and its
``src`` on the path, every cell at the tiny size its files give (the
configuration's ``tiny`` block, the traffic's ``tiny`` keys), and the card
fixture of the tests that need one."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from spmvbench import run  # noqa: E402

# a few threads a test process: several processes share the host's cores,
# and the served cell's tiny open loop runs on the real clock
torch.set_num_threads(2)

#: every cell of BENCHMARK.json
CELLS = [c["name"] for c in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]]


def tiny(cell: str, check_all: bool = False) -> dict:
    """The files of ``cell`` cut to a host size: the configuration's
    ``params`` replaced by its ``tiny`` block's, the traffic updated by its
    ``tiny`` keys; ``check_all`` checks 64 answers, most or all of a tiny
    run's, where a run checks its sample."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    entry = {c["name"]: c for c in bench["workloads"]}[cell]
    config = run.load_json(run.HERE / "configs" / f"{entry['config']}.json")
    config["params"] = config["tiny"]["params"]
    traffic = run.load_json(run.HERE / "traffic" / f"{entry['traffic']}.json")
    traffic.update(traffic["tiny"])
    if check_all:
        traffic["samples"] = 64
    return {"bench": bench, "config": config, "traffic": traffic}


def run_tiny(cell: str, seed: int = 1234567890123, seconds: float = 0.3, trace: bool = False,
             check_all: bool = False) -> dict:
    return run.run_cell(cell, seed, seconds, trace, "cpu", out=lambda s: None,
                        **tiny(cell, check_all))


@pytest.fixture
def card():
    """The CUDA device; skips the test on a host without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark's runs and controls at full size)")
    return torch.device("cuda", 0)
