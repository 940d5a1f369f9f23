"""The 500k served cell (``titles-500k-latency.serve``) against the benchmark's
plain reference on the CPU, cut to 4,000 truth titles (one 4,096-title block)
on the folded engine.

``benchmark.drive.run_cell`` serves one second of the cell's open-loop
single titles (40 a second) through ``Matcher.predict(single=True)`` and
holds every sampled answer against ``benchmark/reference/``: on two seeds
every decision and every retrieval slot agree, no request fails, and the
one-dispatch program that served them ran in its folded mode.  The run
refuses a process that has loaded JAX, which this suite's ``conftest.py``
does, so it runs in a child process of its own, with torch on one thread.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "titles-500k-latency.serve"
SEEDS = (2**31 + 24, 3_000_000_017)


def serve_cell(root: str, seeds) -> list:
    """Run the cut cell once per seed (in a process without JAX) and return
    each result line with the modes the one-dispatch program served in."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark.catalog import BENCH_DIR, Catalog
    from benchmark.drive import run_cell

    torch.set_num_threads(1)
    for kind in ("configs", "traffic"):
        os.makedirs(os.path.join(root, kind), exist_ok=True)
    cat = Catalog(dirs=[BENCH_DIR])
    wl = cat.workload(CELL)
    config = cat.config(wl["config"])
    config["truth_titles"] = 4000
    # 4,000 titles padded to one 4,096-title block, not the card's 32,768:
    # the plain version of kernel A then scores an eighth of the padding
    config["matcher"] = dict(config["matcher"], retrieval_mode="folded", title_block=4096)
    with open(os.path.join(root, "configs", wl["config"] + ".json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(root, "traffic", wl["traffic"] + ".json"), "w") as f:
        json.dump(dict(cat.traffic(wl["traffic"]), rate_per_s=40), f)
    cut = Catalog(dirs=[root, BENCH_DIR])
    out = []
    for seed in seeds:
        modes = []

        def watch(matcher):
            fused = matcher._fused_engine()
            dispatch = fused.dispatch

            def counted(queries, rows, eager=False):
                modes.append(fused.mode)
                return dispatch(queries, rows, eager)

            fused.dispatch = counted

        result = run_cell(CELL, seed, 1.0, False, device="cpu", catalog=cut, log=lambda s: None,
                          tamper=watch)
        out.append(dict(result, modes=modes))
    return out


def test_the_cut_cell_equals_the_reference_on_the_cpu(tmp_path):
    code = (f"import sys, json; sys.path.insert(0, {os.path.dirname(__file__)!r}); "
            f"import test_torch_serve_folded_reference as t; "
            f"print(json.dumps(t.serve_cell({str(tmp_path)!r}, {list(SEEDS)!r})))")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-4000:]
    results = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(results) == len(SEEDS)
    for out in results:
        assert out["correct"], out["checks"]
        assert out["checks"]["decision_mismatch"]["value"] == 0.0
        assert out["checks"]["retrieval_mismatch"]["value"] == 0.0
        assert out["attempted"] == 40 and out["failed"] == 0
        assert out["modes"] and set(out["modes"]) == {"folded"}
        assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", ["kernel_a_roofline_pct.serve", "fused_plan_ms.serve",
                                  "single_p50_ms", "single_p95_ms", "host_ms.serve"])
def test_the_cell_reports_its_metrics(name):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.catalog import Catalog

    cat = Catalog()
    reported = [m["name"] for s in ("end_to_end", "per_layer") for m in cat.metrics(s, CELL)]
    assert name in reported
    assert callable(cat.reader(name))
