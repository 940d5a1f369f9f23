"""Run one cell of the port's benchmark once, on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the set-up, the window and each number compared with its limit on
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``.  Exits 2, printing no
result, where there is no card or fewer than the cell needs, or where a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = p.parse_args(argv)
    from benchmark.drive import Refused, run_cell

    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except Refused as exc:
        print(f"refused: {exc}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
