"""PyTorch port, the mesh's shards at once (``parallel/sharded.py``): grouped
retrieval, the workers, ``row_parallel`` and their errors, on CPU meshes.

Grouped retrieval (``dispatch_blocks`` blocks a group, every shard on its
card's worker, one merge a group) is held **bit for bit** to the merge it
replaced, block by block: each shard's engine on each block, the shards'
top-k concatenated shard by shard and stably sorted, written out here as
the reference.  Against the single device: bit for bit; against the JAX
mesh (window select through ``pallas_interpret``): scores to rtol 1e-6,
positions equal on untied slots, as ``tests/test_torch_sharded.py`` holds
the mesh.  The cascade: ids and stages equal, predictions to 1e-6 (see
that file's docstring).
"""

import random
import string
import sys
import threading

import numpy as np
import pytest
import torch

from doppelspeller_tpu.config import Config as JConfig
from doppelspeller_tpu.ops.ngram_index import build_truth_index as jbuild_truth_index
from doppelspeller_tpu.parallel import sharded as jsharded
from doppelspeller_tpu.utils.io import TitleSet as JTitleSet
from doppelspeller_tpu_torch import _build
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.ops.fold import plan_id_blocks
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index, plan_query_blocks
from doppelspeller_tpu_torch.parallel.sharded import (
    ShardedJaccardScorer,
    ShardError,
    Workers,
    make_mesh,
    row_parallel,
)
from doppelspeller_tpu_torch.pipeline import Matcher
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import MODEL, EagerGraphs, compare_predictions, port_config, untied


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _titles(n, rng):
    alphabet = string.ascii_lowercase + "  01"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(5, 30))).strip() or "abc"
            for _ in range(n)]


@pytest.fixture(scope="module")
def world():
    """600 titles (``title_block`` 128, ``query_block`` 8) and 70 queries, 9
    blocks, the last of 6 rows; on both sides: (JAX config, truth, queries,
    index, port config, truth, queries, index)."""
    rng = random.Random(9)
    jcfg = JConfig(data_path="/tmp/x", title_block=128, query_block=8, score_dtype="float32")
    jtruth = JTitleSet.from_titles(_titles(600, rng), config=jcfg)
    jq = JTitleSet.from_titles(_titles(66, rng) + [jtruth.transformed[i] for i in (4, 250, 260, 599)],
                               config=jcfg)
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    queries = TitleSet.from_titles(jq.titles, ids=jq.ids, config=cfg)
    return (jcfg, jtruth, jq, jbuild_truth_index(jtruth, jcfg),
            cfg, truth, queries, build_truth_index(truth, cfg))


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def _block_by_block(sc, queries, k):
    """The merge the grouped one replaced: per block, each shard's top-k
    (positions made global), concatenated shard by shard, stably sorted."""
    vals, pos = [], []
    if sc.exact is not None:
        plans = plan_query_blocks(queries, sc.index, sc.cfg)
        blocks = [(torch.from_numpy(p.union_ids), torch.from_numpy(p.w_pos)) for p in plans]
        engines = [lambda b, e=e: e.topk_union(*b, k) for e in sc.exact]
    else:
        plans = plan_id_blocks(queries, sc.cfg)
        blocks = [torch.from_numpy(p.ids).to(torch.int64) for p in plans]
        engines = [lambda b, e=e: e.topk_block(b, k) for e in sc.folded]
    for p, b in zip(plans, blocks):
        parts = [eng(b) for eng in engines]
        v = torch.cat([v for v, _ in parts], dim=1)
        ps = torch.cat([ps + lo for (_, ps), lo in zip(parts, sc.offsets)], dim=1)
        v, order = torch.sort(v, dim=1, descending=True, stable=True)
        vals.append(v[: p.n_valid, :k])
        pos.append(torch.gather(ps, 1, order[:, :k])[: p.n_valid])
    return torch.cat(vals).numpy(), torch.cat(pos).numpy()


MODES = {
    "exact": dict(retrieval_mode="exact"),
    "exact_full": dict(retrieval_mode="exact", retrieval_window_select=False),
    "exact_split": dict(retrieval_mode="exact", union_buckets=(64, 96, 128)),
    "folded": dict(retrieval_mode="folded", fold_dim=256, rescore_depth=32),
}


@pytest.mark.parametrize("dispatch_blocks", [1, 2, 32])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_grouped_retrieval_is_the_block_by_block_merge(world, mode, dispatch_blocks):
    """Three shards; groups of 1, 2 (a ragged last group) and 32 blocks (one
    group); ``exact_split``'s small unions split blocks, so one group holds
    blocks of several union sizes and of fewer rows."""
    *_, cfg, truth, queries, index = world
    cfg = cfg.with_(dispatch_blocks=dispatch_blocks, **MODES[mode])
    sc = ShardedJaccardScorer(index, make_mesh(3, platform="cpu"), cfg, truth=truth)
    assert (sc.folded is not None) == (mode == "folded")
    seen = []
    real = sc.workers.submit
    sc.workers.submit = lambda job, shards=None: seen.append(threading.get_ident()) or real(job, shards)
    got = sc.topk(queries, k=12)
    n_blocks = len(plan_id_blocks(queries, cfg) if mode == "folded"
                   else plan_query_blocks(queries, index, cfg))
    assert len(seen) == -(-n_blocks // dispatch_blocks)          # one issue a group
    _equal(_block_by_block(sc, queries, 12), got)
    if mode != "folded":
        _equal(JaccardScorer(index, cfg, "cpu").topk(queries, k=12), got)
    sc.close()


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_concurrent_mesh_is_the_single_device_and_the_jax_mesh(world, score_dtype):
    jcfg, _jt, jq, jindex, _cfg, _t, queries, index = world
    jcfg = jcfg.with_(retrieval_impl="pallas_interpret", topk_recall_target=1.0,
                      score_dtype=score_dtype, dispatch_blocks=2)
    sj, pj = jsharded.ShardedJaccardScorer(jindex, jsharded.make_mesh(4), jcfg).topk(jq, k=15)
    cfg = port_config(jcfg)
    sc = ShardedJaccardScorer(index, make_mesh(4, platform="cpu"), cfg)
    sp, pp = sc.topk(queries, k=15)
    _equal(JaccardScorer(index, cfg, "cpu").topk(queries, k=15), (sp, pp))
    np.testing.assert_allclose(sp, sj, rtol=1e-6, atol=1e-7)
    sep = untied(sj)
    assert sep.sum() > 300
    np.testing.assert_array_equal(pp[sep], pj[sep])


@pytest.mark.parametrize("window_select", [True, False])
def test_ties_across_shard_boundaries_keep_the_single_device_order_in_groups(world, window_select):
    """Copies of titles on both sides of every boundary of a 4-shard mesh,
    one block a group: the tied copies keep the single device's order."""
    *_, cfg, truth, _q, _i = world
    titles = list(truth.titles)
    for b in (256, 512):
        for j in range(6):
            titles[b + j] = titles[b - 6 + j]
    truth2 = TitleSet.from_titles(titles, config=cfg)
    queries = TitleSet.from_titles([titles[b - 6 + j] for b in (256, 512) for j in range(6)]
                                   + [titles[b - 6 + j][:-2] for b in (256, 512) for j in range(6)],
                                   config=cfg)
    cfg = cfg.with_(retrieval_window_select=window_select, dispatch_blocks=1)
    index = build_truth_index(truth2, cfg)
    single = JaccardScorer(index, cfg, "cpu").topk(queries, k=10)
    mesh = ShardedJaccardScorer(index, make_mesh(4, platform="cpu"), cfg).topk(queries, k=10)
    _equal(single, mesh)
    assert (single[0][:12, 0] == single[0][:12, 1]).all()                  # really tied


@pytest.mark.parametrize("n_rows,shards_run", [(10, [0, 1, 2, 3]), (7, [0, 1, 2, 3]),
                                               (2, [0, 1]), (0, [0])])
def test_row_parallel_keeps_row_order(n_rows, shards_run):
    """⌈R/D⌉ rows a shard in order (10 rows: 3, 3, 3, 1; 7 rows: 2, 2, 2,
    1); shards left with no rows are skipped; the parts come back in row
    order, decided on the worker threads."""
    workers = Workers(make_mesh(4, platform="cpu"))
    rows = torch.arange(n_rows * 3, dtype=torch.int64).reshape(n_rows, 3)
    calls = []

    def run(d, part, twice):
        calls.append((threading.get_ident(), part[:, 0].tolist()))
        return part.sum(dim=1), twice * 2

    s, t = row_parallel(workers, run, rows, rows[:, 1])
    assert torch.equal(s, rows.sum(dim=1)) and torch.equal(t, rows[:, 1] * 2)
    assert len(calls) == len(shards_run)
    assert all(tid != threading.get_ident() for tid, _ in calls)
    assert [r for _, part in calls for r in part] == rows[:, 0].tolist()
    workers.close()


def test_row_parallel_graphs_pad_each_part_and_cut_it_back():
    """Each shard's part padded to a power of two rows (at least 64) with
    its first row: the first call of a shape runs each part alone, the
    second captures it, later parts are replayed into the leading rows;
    outputs cut back to the part's rows."""
    workers = EagerGraphs(make_mesh(4, platform="cpu"))
    seen = []

    def run(d, x, y):
        seen.append(x.shape[0])
        return x.sum(dim=1) + y, y * 2

    for n in (10, 7, 10, 200):
        x = torch.arange(n * 3, dtype=torch.int64).reshape(n, 3) + n
        y = torch.arange(n, dtype=torch.int64) * 5
        s, t = row_parallel(workers, run, x, y, graph=("step",))
        assert torch.equal(s, x.sum(dim=1) + y) and torch.equal(t, y * 2)
    keys = sorted({key for _, key in workers.graphs})
    assert [key[:2] for key in keys] == [("step", 64)]              # 10, 7 and 200 rows: 64 a shard
    assert workers.captures["step"] == [1, 1, 1, 1] and workers.replays["step"] == [2, 2, 2, 2]
    assert seen[:4] == [3, 3, 3, 1] and set(seen[4:]) == {64}        # 10 rows alone, then padded
    workers.close()


def test_an_error_on_a_shard_names_it_and_the_mesh_goes_on(world, monkeypatch):
    *_, cfg, truth, queries, index = world
    sc = ShardedJaccardScorer(index, make_mesh(3, platform="cpu"), cfg.with_(dispatch_blocks=2))
    ref = sc.topk(queries, k=12)

    def boom(*args, **kwargs):
        raise RuntimeError("engine fault")

    monkeypatch.setattr(sc.exact[1], "topk_union", boom)
    with pytest.raises(ShardError, match=r"^shard 1 on cpu: RuntimeError: engine fault$") as err:
        sc.topk(queries, k=12)
    assert err.value.shard == 1 and isinstance(err.value.__cause__, RuntimeError)
    monkeypatch.undo()
    _equal(ref, sc.topk(queries, k=12))

    def run(d, x):
        if x[0] >= 3:
            raise ValueError(f"row {int(x[0])}")
        return (x,)

    x = torch.arange(8)                                # shards of 3, 3 and 2 rows
    with pytest.raises(ShardError, match="^shard 1 on cpu: ValueError: row 3$"):
        row_parallel(sc.workers, run, x)               # shard 1 fails (shard 2 would too)
    assert torch.equal(row_parallel(sc.workers, lambda d, x: (x + 1,), x)[0], x + 1)
    sc.close()


@pytest.fixture(scope="module")
def world_small():
    """``tests/test_torch_sharded.py``'s ``world_small``, port side only: 220
    titles, k = 15, 64 queries of every stage."""
    rng = random.Random(21)
    jcfg = JConfig(data_path="/tmp/x_mesh", title_block=128, query_block=8, score_dtype="float32",
                   pair_block=64, top_n_predicting=15, top_n_training=5)
    cfg = port_config(jcfg, cascade_impl="device", dispatch_blocks=2)

    def words(n):
        return " ".join("".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(3, 8)))
                        for _ in range(n))

    truth_titles = [words(rng.randint(2, 3)) for _ in range(220)]
    truth = TitleSet.from_titles(truth_titles, ids=np.arange(500, 720), config=cfg)
    test_titles = ([truth_titles[i] for i in range(100, 112)]
                   + [truth_titles[i][:-1] + "x" for i in range(112, 150)] + [words(3) for _ in range(14)])
    return cfg, truth, TitleSet.from_titles(test_titles, ids=np.arange(len(test_titles)), config=cfg)


def test_two_predicts_on_one_mesh_matcher_are_identical(world_small):
    cfg, truth, test = world_small
    model = GBTModel.load(str(MODEL))
    mesh = Matcher(cfg, truth, model, mesh=make_mesh(3, platform="cpu"), use_index_checkpoint=False)
    r1, r2 = mesh.predict(test), mesh.predict(test)
    for name in ("match_title_id", "prediction", "stage"):
        _equal([getattr(r1, name)], [getattr(r2, name)])
    assert r1.match_transformed == r2.match_transformed
    assert all(r1.stage_counts[s] > 0 for s in ("exact", "fuzzy", "model"))
    one = Matcher(cfg, truth, model, device="cpu", use_index_checkpoint=False).predict(test)
    compare_predictions(one, r1)
    np.testing.assert_allclose(one.prediction, r1.prediction, rtol=1e-6)
    mesh.close()
    assert not mesh.scorer.workers._threads


def test_launch_counts_lose_no_update_across_threads():
    """``_build.count`` from 16 threads at a short switch interval: every
    addition lands."""
    fn = lambda: None  # noqa: E731
    fn.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count(fn) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fn.launches == 16 * 2000
