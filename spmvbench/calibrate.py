"""The readings that the correctness limits are set from, in one process.

    python3 -m spmvbench.calibrate --workload hmep.spmv --seeds 11,12,13 \\
        --control-seeds 21,22,23 --seconds 3

For each ``--seeds`` seed: a run of the cell as ``spmvbench.run`` makes it
(set-up, a window of ``--seconds`` at the cell's own load, the check
against the reference) with no limit held, printing every number compared:
the program's readings.  For each ``--control-seeds`` seed: the control,
the reference computed one precision below what the configuration states
and put in the program's place, through the same comparison: the readings
the limits must fail.  One JSON line a reading.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from . import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.use_checkout_paths()
    import torch

    if not torch.cuda.is_available():
        print("spmvbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    bench, entry = run.find_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        line = run.run_cell(args.workload, seed, args.seconds, False, bench=bench, limits={},
                            out=lambda s: print(s, flush=True))
        print(json.dumps({"reading": "program", "seed": seed, "metrics": line["metrics"],
                          "numbers": {k: v["value"] for k, v in line["checks"].items()}}),
              flush=True)
    config = run.load_json(run.HERE / "configs" / f"{entry['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{entry['traffic']}.json")
    driver = run.load_driver(traffic)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        b = run.Bench(args.workload, config, traffic, seed, args.seconds, False, "cuda")
        b.build_matrix()
        numbers = driver.check(b, driver.control(b))
        print(json.dumps({"reading": "control", "seed": seed, "numbers": numbers}), flush=True)
        del b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
