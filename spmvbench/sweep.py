"""Find the highest rate a served cell sustains: one set-up, then the cell's
open loop at each offered rate in turn, in one process.

    python3 -m spmvbench.sweep --workload hmep.served --seed 5 --seconds 5 \\
        --rates 4000,8000,12000,16000

For each rate it prints the requests offered and completed in the window,
the completed rate, the p50 and p95 latency over the whole window and over
the requests due in its first and second half, how late the generator ran,
and the backlog: requests not complete at the window's end.  A rate is
sustained when all of these hold:

* at least 99 % of its requests complete within the window;
* the p95 latency is at most ``P95_DEADLINES`` deadlines;
* the backlog does not grow: the second half's p95 exceeds the first
  half's by less than one deadline;
* the generator keeps to the schedule: its lateness, 95th percentile, is
  under one deadline.

The knee is the highest rate sustained with every lower rate sustained
too.  Needs the card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

#: the p95 latency of a sustained rate, in deadlines at most
P95_DEADLINES = 3.0


def judge(res: dict, deadline_s: float) -> dict:
    """The numbers of one rate's window and whether the rate is sustained."""
    import numpy as np

    lat, due = res["latency_s"], res["due_s"]
    half = due < res["window_s"] / 2
    p95 = float(np.percentile(lat, 95))
    p95_1 = float(np.percentile(lat[half], 95)) if half.any() else float("nan")
    p95_2 = float(np.percentile(lat[~half], 95)) if (~half).any() else float("nan")
    late95 = float(np.nanpercentile(res["late_s"], 95))
    done = res["completed_in_window"]
    sustained = (done >= 0.99 * res["requests"] and p95 <= P95_DEADLINES * deadline_s
                 and p95_2 - p95_1 < deadline_s and late95 < deadline_s)
    return {"offered": res["requests"], "completed": done,
            "completed_per_s": done / res["window_s"],
            "p50_ms": float(np.percentile(lat, 50)) * 1e3, "p95_ms": p95 * 1e3,
            "p95_first_half_ms": p95_1 * 1e3, "p95_second_half_ms": p95_2 * 1e3,
            "gen_late_p95_ms": late95 * 1e3, "backlog": res["requests"] - done,
            "sustained": bool(sustained)}


def main(argv=None) -> int:
    from . import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    run.use_checkout_paths()
    import torch

    if not torch.cuda.is_available():
        print("spmvbench.sweep: needs a CUDA device", file=sys.stderr)
        return 2
    bench, entry = run.find_cell(args.workload)
    config = run.load_json(run.HERE / "configs" / f"{entry['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{entry['traffic']}.json")
    b = run.Bench(args.workload, config, traffic, args.seed, args.seconds, False, "cuda")
    b.build_matrix()
    driver = run.load_driver(traffic)
    state = driver.setup(b)
    gc.collect()
    gc.freeze()
    knee, broken = None, False
    for rate in sorted(float(r) for r in args.rates.split(",")):
        b.traffic = dict(traffic, rate_per_s=rate)
        res = driver.window(b, state)
        row = judge(res, float(traffic["deadline_s"]))
        broken |= not row["sustained"]
        if not broken:
            knee = rate
        print(json.dumps({"offered_per_s": rate, **row, "summary": res["summary"]}),
              flush=True)
    print(json.dumps({"knee_per_s": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
