"""Parts are found by name: a configuration, a traffic mix, a metric and a
cell's limits added as new files under a search folder run with no edit to
an existing file; the measured path refuses to run without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.catalog import ROOT
from benchmark.drive import Refused, run_cell
from benchmark.tests.helpers import one_thread, tiny_catalog


def test_a_new_config_mix_metric_and_cell_are_found_by_name(tmp_path):
    one_thread()
    cat = tiny_catalog(str(tmp_path))
    d = str(tmp_path)
    cfg = cat.config("tiny-exact")
    cfg["truth_titles"] = 3000
    cfg["batch_queries"] = 64
    with open(os.path.join(d, "configs", "new-config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(d, "traffic", "new-mix.json"), "w") as f:
        json.dump({"loop": "closed", "pool_batches": 1,
                   "mix": {"exact": 0.2, "misspelled": 0.4, "absent": 0.4}, "sample": 16}, f)
    os.makedirs(os.path.join(d, "metrics"), exist_ok=True)
    with open(os.path.join(d, "metrics", "predicts_in_window.py"), "w") as f:
        f.write("def read(run):\n    return len(run.predicts)\n")
    with open(os.path.join(d, "limits", "new-config.new-mix.json"), "w") as f:
        json.dump(cat.limits("tiny-exact.batch"), f)
    cat.spec["workloads"].append({"name": "new-config.new-mix", "config": "new-config",
                                  "traffic": "new-mix", "chips": 1, "why": "added by files"})
    cat.spec["end_to_end"].append({"name": "predicts_in_window", "unit": "predicts",
                                   "better": "higher", "bound": 0.1, "source": "host_clock",
                                   "workloads": ["new-config.new-mix"]})
    out = run_cell("new-config.new-mix", 77, 0.5, False, device="cpu", catalog=cat,
                   log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["metrics"]["predicts_in_window"]["value"] >= 1
    assert out["attempted"] % 64 == 0


def test_the_measured_path_needs_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cat = tiny_catalog(str(tmp_path))
    with pytest.raises(Refused):
        run_cell("tiny-exact.batch", 1, 0.5, False, catalog=cat, log=lambda s: None)


def test_the_command_exits_nonzero_and_prints_nothing_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "titles-30k.batch",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
