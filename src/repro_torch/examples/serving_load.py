"""End-to-end example: micro-batched SpMV serving under synthetic load.

An open-loop load generator (arrivals don't wait for completions -- the
regime where batching matters) drives ``BatchingSpMVServer`` at two traffic
rates against the same operator:

* **heavy** traffic fills batches before the deadline: width-driven
  flushes, near-zero padding, throughput approaching the SpMM roofline;
* **thin** traffic never fills a batch: deadline-driven flushes keep
  latency bounded, and the padding ratio records the price.

Arrivals are a deterministic Poisson process on a *virtual* clock (the
server's ``clock`` is injectable), so the queue dynamics -- flush reasons,
batch widths, padding -- are exactly reproducible for one chip; the width
itself is the one ``perfmodel.select_batch_width`` prices on the server's
chip, and only the reported wall-clock throughput varies with the host.

    PYTHONPATH=src python -m repro_torch.examples.serving_load --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serving_load --n 1201200

Runs on the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import formats as F
from ..core.matrices import holstein_hubbard_surrogate
from ..serve import BatchingSpMVServer
from ..utils.hw import default_device, synchronize


class VirtualClock:
    """The simulation's time source; the generator advances it by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def run_load(name, rate_qps, n_requests, deadline_s, matrix, xs, *, device, chip=None) -> dict:
    """Drive one open-loop run on ``device`` (the server priced on ``chip``,
    default its own); returns the server's stats, the virtual latencies,
    the wall seconds, the policy width, the futures in submission order and
    the server."""
    clock = VirtualClock()
    srv = BatchingSpMVServer(deadline_s=deadline_s, clock=clock, device=device, chip=chip)
    srv.register(name, matrix)
    width = srv.stats()[name]["batch_width"]

    rng = np.random.default_rng(42)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_qps, n_requests))
    inflight = []  # (t_arrival, future)
    latencies = []
    futures = []

    def drain():
        done = [(t0, f) for t0, f in inflight if f.done()]
        for t0, _ in done:
            latencies.append(clock.t - t0)
        inflight[:] = [(t0, f) for t0, f in inflight if not f.done()]

    synchronize(srv.device)
    t_wall = time.perf_counter()
    for t_arr, x in zip(arrivals, xs[:n_requests]):
        # advance virtual time to the arrival, flushing overdue batches
        # on the way (the cooperative stand-in for a flusher thread)
        clock.t = float(t_arr)
        srv.pump()
        drain()
        fut = srv.submit(name, x)
        futures.append(fut)
        inflight.append((clock.t, fut))
        drain()
    clock.t = float(arrivals[-1]) + deadline_s
    srv.pump()
    srv.flush(name)
    drain()
    for f in futures:
        f.result()
    synchronize(srv.device)
    wall_s = time.perf_counter() - t_wall

    st = srv.stats()[name]
    lat = np.array(latencies)
    p50, p95 = np.percentile(lat, 50), np.percentile(lat, 95)
    print(f"[{name}] rate={rate_qps:g} req/s  policy width={width} "
          f"deadline={deadline_s * 1e3:g} ms  [{st['format']}/{st['kernel']}]")
    print(f"    {st['requests']} requests in {st['batches']} batches, "
          f"mean width {st['mean_batch_width']:.2f}, "
          f"padding ratio {st['padding_ratio']:.2f}")
    print(f"    queueing latency (virtual): p50={p50 * 1e3:.2f} ms "
          f"p95={p95 * 1e3:.2f} ms")
    print(f"    wall-clock service throughput: {st['requests'] / wall_s:.0f} req/s")
    return {"stats": st, "latencies": lat, "p50": float(p50), "p95": float(p95),
            "wall_s": wall_s, "req_per_s": st["requests"] / wall_s, "width": width,
            "futures": futures, "server": srv}


def main(argv=None) -> dict:
    """Heavy and thin traffic against one SELL operator; returns the
    container, the request vectors and both runs."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3000, help="surrogate rows")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    n = args.n
    m = holstein_hubbard_surrogate(n, seed=0)
    sell = F.convert(m, "sell", C=8)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((240, n)).astype(np.float32)).to(dev).unbind(0)

    # heavy traffic: arrivals far faster than the deadline -> width flushes
    heavy = run_load("heavy", rate_qps=50_000, n_requests=240,
                     deadline_s=2e-3, matrix=sell, xs=xs, device=dev)
    # thin traffic: the deadline fires long before a batch fills
    thin = run_load("thin", rate_qps=500, n_requests=60,
                    deadline_s=2e-3, matrix=sell, xs=xs, device=dev)

    if not heavy["stats"]["mean_batch_width"] > thin["stats"]["mean_batch_width"]:
        raise AssertionError("heavy traffic must batch wider than thin traffic")
    if not thin["stats"]["padding_ratio"] > heavy["stats"]["padding_ratio"]:
        raise AssertionError("thin traffic must pad more than heavy traffic")
    print("[load] heavy traffic batches wide; thin traffic trades padding "
          "for bounded latency -- the flush policy working as designed")
    return {"matrix": sell, "xs": xs, "heavy": heavy, "thin": thin}


if __name__ == "__main__":
    main()
