"""The control of the comparison that decides ``correct``: the reference put
in the program's place and computed in the precision below the one the
configuration states (its ``control`` entry: float8 coarse weights for the
stated bfloat16, bfloat16 for the stated float32 rescore and features).
Each number it reads is printed; the control has to come out as not
correct against the cell's limits.

    python benchmark/control.py --workload <cell> --seeds 11,12,13

It draws each seed's world, traffic and sample as a run of the cell does,
and needs no window: the program is not run.  Runs on the card where there
is one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import judge as J  # noqa: E402
from benchmark.catalog import Catalog  # noqa: E402
from benchmark.traffic import make_traffic  # noqa: E402
from benchmark.world import World  # noqa: E402


def control_numbers(cell: str, seed: int, seconds: float, device: str,
                    catalog: Optional[Catalog] = None, which: str = "control") -> Dict:
    """The numbers the comparison reads when the reference in the
    ``which`` precision ("control", or "precision" as stated) answers in
    the program's place."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cat = catalog or Catalog()
    wl = cat.workload(cell)
    config = cat.config(wl["config"])
    world = World(int(config["truth_titles"]), seed)
    traffic = make_traffic(world, cat.traffic(wl["traffic"]), seconds, seed, config.get("batch_queries"))
    if traffic.loop == "closed":
        queries = [traffic.pool[b][r] for b, rows in enumerate(traffic.sample_rows) for r in rows]
        batch_of = [b for b, rows in enumerate(traffic.sample_rows) for _ in rows]
        single = [False] * len(queries)
        batches = traffic.pool
    else:
        queries = [traffic.requests[i] for i in traffic.sample]
        batch_of = [0] * len(queries)
        single = [True] * len(queries)
        batches = [[]]
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "model",
                              "bench_model_r60.npz")) as z:
        model = {k: z[k] for k in z.files}
    ref = J.Reference(world.titles, dict(config["matcher"]), model, device)
    answers = ref.outputs(queries, batches, batch_of, single, config[which])
    if traffic.loop == "open":
        for a in answers:              # the served path reports no scores
            a.scores = None
    return ref.judge(answers, batches, config["precision"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--which", default="control", choices=["control", "precision"])
    args = p.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cat = Catalog()
    seconds = args.seconds or float(cat.spec["run_seconds"])
    limits = cat.limits(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        numbers = control_numbers(args.workload, seed, seconds, device, cat, args.which)
        fails = [k for k, v in numbers.items() if v is not None and v > limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed, "which": args.which,
                          "numbers": numbers, "fails": fails, "seconds": time.time() - t,
                          "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
