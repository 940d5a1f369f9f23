"""PyTorch port, data-parallel boosting on a mesh and the ``--devices``
verbs, against the port's single device and the JAX package's mesh.

The mesh is ``make_mesh(n, platform="cpu")`` (see
``tests/test_torch_sharded.py``).  Tolerances:

- the port's mesh against its single device: **bit for bit**
  (``dp_boost_round``'s tree and margins, ``train_gbt``'s and
  ``train_model``'s every tree, field by field); the CLI's model tree for
  tree and its predictions file byte for byte, ``serve``'s replies key for
  key but for ``latency_ms``;
- ``dp_boost_round`` against the JAX package's on inputs whose f32 sums are
  exact (its test's): structure equal, values and margins to 1e-6;
- ``train_gbt(mesh=)`` against the JAX mesh: that test's own tolerances
  (``tests/test_parallel.py::test_train_gbt_mesh_matches_single_device``:
  the JAX mesh sums its histograms in another order than its single
  device, so near-tied splits may part);
- the predictions file of ``generate-predictions --devices 2`` against the
  JAX CLI's under the same flags and model: byte for byte, as
  ``tests/test_torch_cli.py`` compares the single-device files.
"""

import io
import json
import logging
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from jax.sharding import NamedSharding, PartitionSpec as P

from doppelspeller_tpu import config as jconfig
from doppelspeller_tpu.cli import cli as jcli
from doppelspeller_tpu.models import gbt as jgbt
from doppelspeller_tpu.parallel import sharded as jsharded
from doppelspeller_tpu_torch import cli as pcli
from doppelspeller_tpu_torch import config as pconfig
from doppelspeller_tpu_torch.models import gbt as pgbt
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.models.trainer import train_model
from doppelspeller_tpu_torch.parallel.sharded import dp_boost_round, make_mesh
from doppelspeller_tpu_torch.utils.io import TitleSet
from doppelspeller_tpu_torch.utils.misspell import generate_misspelled_name
from test_cli import _make_tiny_dataset
from test_torch_cli import SERVE_REQUESTS
from test_torch_helpers import port_config
from test_torch_sharded import world_small  # noqa: F401  (a fixture)

TREE_FIELDS = ("feat", "split_bin", "missing_left", "value", "is_leaf", "threshold")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_trees(a, b):
    assert a.num_trees == b.num_trees and a.best_ntree_limit == b.best_ntree_limit
    for f in TREE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


# ------------------------------------------------------------- one round

def _round_inputs():
    """``tests/test_parallel.py::test_dp_boost_round_matches_single``'s inputs."""
    rng = np.random.RandomState(0)
    N, F = 1024, 12
    X = rng.randn(N, F).astype(np.float32)
    y = (X[:, 0] - X[:, 3] > 0).astype(np.float32)
    return pgbt.bin_features(X, pgbt.compute_bin_edges(X)), y


@pytest.mark.parametrize("n_dev,n_rows", [(8, 1024), (3, 1000)])
def test_dp_boost_round_is_one_build_tree_round(n_dev, n_rows):
    bins, y = _round_inputs()
    bins, y = torch.from_numpy(bins[:n_rows]), torch.from_numpy(y[:n_rows])
    m0 = torch.linspace(-1.0, 1.0, n_rows)            # margins whose sigmoid is not exact
    g, h = pgbt.margin_grad_hess(m0, y, 5.0)
    *tree, contrib = pgbt.build_tree(bins, g, h, depth=4, lambda_=1.0, min_child_weight=1.0)
    per = -(-n_rows // n_dev)
    cut = [slice(i * per, (i + 1) * per) for i in range(n_dev)]
    m_new, tree_p = dp_boost_round(make_mesh(n_dev, platform="cpu"), [bins[s] for s in cut],
                                   [y[s] for s in cut], [m0[s] for s in cut], depth=4, eta=0.3,
                                   beta=5.0)
    tree[3] = tree[3] * 0.3
    for a, b in zip(tree, tree_p):
        assert torch.equal(a, b)
    assert torch.equal(torch.cat(m_new), m0 + 0.3 * contrib)
    assert (tree_p[0] >= 0).sum() >= 4                                 # it really split


def test_dp_boost_round_matches_the_jax_mesh():
    bins, y = _round_inputs()
    N = len(y)
    mesh = jsharded.make_mesh(8, axis="data")
    sh = NamedSharding(mesh, P("data"))
    m_j, tree_j = jsharded.dp_boost_round(
        mesh, jax.device_put(jnp.asarray(bins), sh), jax.device_put(jnp.asarray(y), sh),
        jax.device_put(jnp.zeros(N, jnp.float32), sh), depth=4, eta=1.0, beta=5.0)
    per = N // 8
    m_p, tree_p = dp_boost_round(
        make_mesh(8, axis="data", platform="cpu"),
        [torch.from_numpy(bins[i * per : (i + 1) * per]) for i in range(8)],
        [torch.from_numpy(y[i * per : (i + 1) * per]) for i in range(8)],
        [torch.zeros(per) for _ in range(8)], depth=4, eta=1.0, beta=5.0)
    for i, (a, b) in enumerate(zip(tree_j, tree_p)):
        a, b = np.asarray(a), b.numpy()
        if i == 3:
            np.testing.assert_allclose(b, a, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(torch.cat(m_p).numpy(), np.asarray(m_j), atol=1e-6)


# ------------------------------------------------------------ train_gbt

@pytest.fixture(scope="module")
def gbt_data():
    """``tests/test_parallel.py::test_train_gbt_mesh_matches_single_device``'s
    data: N = 1003, not a multiple of the shards."""
    rng = np.random.RandomState(3)
    N, F = 1003, 16
    X = rng.randn(N, F).astype(np.float32)
    X[rng.rand(N, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 5])) > 0).astype(np.float32)
    return X, y, X[:117].copy(), y[:117].copy()


@pytest.mark.parametrize("n_dev", [2, 8])
def test_train_gbt_on_a_mesh_is_the_single_device_bit_for_bit(gbt_data, n_dev):
    X, y, Xe, ye = gbt_data
    params = pgbt.GBTParams(depth=4, num_boost_round=12, early_stopping_rounds=12)
    one = pgbt.train_gbt(X, y, Xe, ye, params, verbose_every=0, device="cpu")
    mesh = pgbt.train_gbt(X, y, Xe, ye, params, verbose_every=0,
                          mesh=make_mesh(n_dev, axis="data", platform="cpu"))
    _same_trees(one, mesh)
    assert one.history == mesh.history


def test_train_gbt_on_a_mesh_matches_the_jax_mesh(gbt_data):
    X, y, Xe, ye = gbt_data
    jparams = jgbt.GBTParams(depth=4, num_boost_round=12, early_stopping_rounds=12)
    m_j = jgbt.train_gbt(X, y, Xe, ye, jparams, verbose_every=0,
                         mesh=jsharded.make_mesh(8, axis="data"))
    m_p = pgbt.train_gbt(X, y, Xe, ye, pgbt.GBTParams(depth=4, num_boost_round=12,
                                                      early_stopping_rounds=12),
                         verbose_every=0, mesh=make_mesh(8, axis="data", platform="cpu"))
    assert m_p.num_trees == m_j.num_trees
    assert abs(m_p.best_ntree_limit - m_j.best_ntree_limit) <= 2
    assert (m_p.feat == m_j.feat).mean() > 0.98
    assert (m_p.split_bin == m_j.split_bin).mean() > 0.95
    np.testing.assert_allclose(m_p.history["eval_error"], m_j.history["eval_error"], atol=3)
    p_p, p_j = m_p.predict(X, device="cpu"), m_j.predict(X)
    assert np.mean(np.abs(p_p - p_j)) < 1e-3
    assert np.mean((p_p > 0.9) != (p_j > 0.9)) < 0.005


def test_train_model_on_a_mesh_is_the_single_device(world_small):
    """Retrieval over the sharded index (never folded), then data-parallel
    boosting: the same pairs, features and trees as one device."""
    *_, cfg, truth, _test = world_small
    rng = random.Random(5)
    titles = [generate_misspelled_name(truth.transformed[i], rng) for i in range(50)] + \
        [f"zq{i} unknown holdings" for i in range(25)]
    labels = np.array([int(truth.ids[i]) for i in range(50)] + [-1] * 25)
    train = TitleSet.from_titles(titles, ids=np.arange(75), labels=labels, config=cfg)
    m1, r1 = train_model(cfg, train=train, truth=truth, save=False, device="cpu")
    m2, r2 = train_model(cfg, train=train, truth=truth, save=False,
                         mesh=make_mesh(8, platform="cpu"))
    _same_trees(m1, m2)
    assert r1["pairs_by_kind"] == r2["pairs_by_kind"] and r1["n_pairs"] == r2["n_pairs"]
    assert set(r2["timings"]) == {"setup_seconds", "candidates_seconds", "features_seconds",
                                  "boosting_seconds"}


# ------------------------------------------------------------------- CLI

def _jax(jcfg, args, stdin=None):
    jconfig.set_config(jcfg)
    try:
        r = CliRunner().invoke(jcli, args, input=stdin, catch_exceptions=False)
    finally:
        jconfig.set_config(jconfig.Config())
    assert r.exit_code == 0, r.output
    return r.output


def _port(cfg, args, capsys, monkeypatch, stdin=None):
    monkeypatch.setattr(pconfig, "_DEFAULT", cfg)
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    capsys.readouterr()
    rc = pcli.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    """Data directories with the tiny dataset of ``tests/test_cli.py``: one
    for the JAX CLI, one for the port on one device, one on a mesh."""
    tmp = tmp_path_factory.mktemp("cli_mesh")
    out = []
    for name in ("jax", "one", "mesh"):
        (tmp / name).mkdir()
        jcfg = jconfig.Config(
            data_path=str(tmp / name), title_block=128, query_block=8, pair_block=64,
            top_n_predicting=15, top_n_training=5, gbt_num_boost_round=15,
            gbt_early_stopping_rounds=15, score_dtype="float32", retrieval_impl="pallas_interpret")
        _make_tiny_dataset(jcfg)
        out.append(jcfg)
    return out[0], port_config(out[1]), port_config(out[2])


def test_cli_verbs_on_a_mesh_equal_one_device_and_the_jax_cli(cli_dirs, capsys, monkeypatch,
                                                               caplog):
    jcfg, one, mesh = cli_dirs
    flags = ["--devices", "2", "--platform", "cpu"]
    _port(one, ["train-model"], capsys, monkeypatch)
    out = _port(mesh, ["train-model"] + flags, capsys, monkeypatch)
    assert out.startswith("trees=15 best=")
    _same_trees(GBTModel.load(one.model_path), GBTModel.load(mesh.model_path))

    shutil.copy(one.model_path, jcfg.model_path)
    out = _port(mesh, ["build-index"] + flags, capsys, monkeypatch)
    assert out.strip() == f"index saved to {mesh.index_path} (100 titles, 1 MB packed)"
    caplog.set_level(logging.INFO, logger="doppelspeller_tpu_torch.pipeline")
    _port(mesh, ["generate-predictions"] + flags, capsys, monkeypatch)
    assert "onto the mesh" in caplog.text
    _port(one, ["generate-predictions"], capsys, monkeypatch)
    _jax(jcfg, ["generate-predictions"] + flags)
    with open(mesh.final_output_path, "rb") as f:
        got = f.read()
    for path in (one.final_output_path, jcfg.final_output_path):
        with open(path, "rb") as f:
            assert f.read() == got

    stdin = "\n".join(SERVE_REQUESTS) + "\n"
    replies = []
    for cfg, extra in ((one, []), (mesh, flags)):
        lines = _port(cfg, ["serve", "--no-warmup"] + extra, capsys, monkeypatch, stdin).splitlines()
        replies.append([json.loads(ln) for ln in lines if ln.startswith("{")])
    for r in replies:
        for x in r:
            x.pop("latency_ms", None)
    assert len(replies[1]) == 7 and replies[0] == replies[1]
