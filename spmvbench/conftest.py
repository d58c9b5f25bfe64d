"""Set-up above the benchmark's tests.  The shared modules of ``tests/``
parametrize over ``conftest.CELLS`` with tables written for the drivers
``closed_spmv``, ``lanczos`` and ``served`` (a tiny configuration each in
``TINY_PARAMS``, the faults each driver's path can take in
``test_bench_faults.APPLIES``).  A cell run by another driver is kept out of
``CELLS`` when the tests' conftest loads, before any module is collected,
and is tested whole in a module of its own: ``hmep_exact.lanczos``
(driver ``lanczos_operator``) in ``tests/test_bench_hmep_exact.py``."""
from __future__ import annotations

from pathlib import Path

#: the drivers the shared tables know
SHARED_DRIVERS = ("closed_spmv", "lanczos", "served")
_TESTS_CONFTEST = Path(__file__).resolve().parent / "tests" / "conftest.py"


def pytest_plugin_registered(plugin, manager):
    path = getattr(plugin, "__file__", None)
    if path is None or Path(path).resolve() != _TESTS_CONFTEST:
        return
    from spmvbench import run

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    driver = {c["name"]: run.load_json(run.HERE / "traffic" / f"{c['traffic']}.json")["driver"]
              for c in bench["workloads"]}
    plugin.CELLS[:] = [c for c in plugin.CELLS if driver[c] in SHARED_DRIVERS]
