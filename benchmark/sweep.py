"""Find an open-loop cell's knee once: its traffic at each of several rates,
one run per rate and seed, printing the latency percentiles and whether the
backlog grew (the generator's lag over the window's last quarter against
its first).

    python benchmark/sweep.py --workload <cell> --rates 10,40,43,46 --seconds 15 \
        --seeds 101,102 --p95-limit-x 2

The first rate stands for the unloaded server: each seed's limit is
``--p95-limit-x`` times its 95th percentile there.  The knee is the highest
rate at which, for every seed, the backlog does not grow and the 95th
percentile stays under that seed's limit; the cell's mix then runs at four
fifths of it.  The rate goes into the mix's file by hand: the benchmark
never searches for a rate during a run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.catalog import BENCH_DIR, Catalog  # noqa: E402
from benchmark.drive import run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seeds", default=str(2**31 + 101))
    p.add_argument("--p95-limit-x", type=float, required=True)
    args = p.parse_args(argv)
    import numpy as np

    base = Catalog()
    wl = base.workload(args.workload)
    mix = base.traffic(wl["traffic"])
    rates = [float(r) for r in args.rates.split(",")]
    passing = {r: True for r in rates}
    limits = {}
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "traffic"))
        for seed in (int(s) for s in args.seeds.split(",")):
            for rate in rates:
                with open(os.path.join(d, "traffic", wl["traffic"] + ".json"), "w") as f:
                    json.dump(dict(mix, rate_per_s=rate), f)
                cat = Catalog(dirs=[d, BENCH_DIR])
                seen = {}

                def keep(run):
                    seen["run"] = run

                out = run_cell(args.workload, seed, args.seconds, False, catalog=cat,
                               log=lambda s: None, on_run=keep)
                run = seen["run"]
                lat = np.asarray(run.latencies_ms)
                lag = np.asarray(run.lag_s)
                q = max(len(lag) // 4, 1)
                grows = bool(lag[-q:].mean() > 2 * lag[:q].mean() + 0.005)
                p95 = float(np.percentile(lat, 95))
                limits.setdefault(seed, args.p95_limit_x * p95)
                ok = not grows and p95 <= limits[seed]
                passing[rate] = passing[rate] and ok
                print(json.dumps({"seed": seed, "rate_per_s": rate, "requests": len(lat),
                                  "p50_ms": float(np.percentile(lat, 50)), "p95_ms": p95,
                                  "p99_ms": float(np.percentile(lat, 99)),
                                  "p95_limit_ms": limits[seed],
                                  "lag_first_quarter_ms": float(lag[:q].mean() * 1e3),
                                  "lag_last_quarter_ms": float(lag[-q:].mean() * 1e3),
                                  "window_s": run.seconds, "backlog_grows": grows, "passes": ok,
                                  "correct": out["correct"]}), flush=True)
    knee = None
    for rate in rates:
        if not passing[rate]:
            break
        knee = rate
    print(json.dumps({"knee_per_s": knee, "four_fifths_per_s": None if knee is None else 0.8 * knee,
                      "rule": f"every seed: no growing backlog, p95 <= {args.p95_limit_x} x its p95 "
                              f"at {rates[0]}/s", "limits_ms": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
