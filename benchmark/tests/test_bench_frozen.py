"""The frozen copies hold: the world generator draws what the program's
bench generator draws, the model file is the program's asset byte for
byte, and a run writes nothing outside its checkout and the given HOME,
XDG_CACHE_HOME and TMPDIR."""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark.catalog import BENCH_DIR, ROOT
from benchmark.world import World


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_the_world_is_the_programs_world(seed):
    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world

    _, truth, queries, actual = make_synthetic_world(3000, 800, seed=seed,
                                                     config=Config(data_path=ROOT))
    world = World(3000, seed)
    q, a = world.queries(800, {"exact": 0.1, "misspelled": 0.6, "absent": 0.3})
    assert world.titles == truth.titles
    assert q == queries.titles
    assert np.array_equal(np.asarray(a), actual)


def test_the_model_is_the_programs_asset():
    asset = os.path.join(ROOT, "doppelspeller_tpu_torch", "assets", "bench_model_r60.npz")
    assert filecmp.cmp(os.path.join(BENCH_DIR, "model", "bench_model_r60.npz"), asset, shallow=False)


def _listing(path):
    try:
        return set(os.listdir(path))
    except OSError:
        return set()


def test_a_run_writes_only_inside_its_places(tmp_path):
    home, cache, tmp = (tmp_path / n for n in ("home", "cache", "tmp"))
    for p in (home, cache, tmp):
        p.mkdir()
    before = {d: _listing(d) for d in ("/tmp", "/dev/shm", ROOT)}
    code = (
        "import torch; torch.set_num_threads(1)\n"
        "from benchmark.tests.helpers import tiny_catalog\n"
        "from benchmark.drive import run_cell\n"
        f"cat = tiny_catalog({str(tmp / 'catalog')!r})\n"
        "run_cell('tiny-folded.serve', 5, 0.5, True, device='cpu', catalog=cat, log=lambda s: None)\n"
    )
    env = dict(os.environ, HOME=str(home), XDG_CACHE_HOME=str(cache), TMPDIR=str(tmp))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    for d, names in before.items():
        new = _listing(d) - names
        assert not new, (d, new)
