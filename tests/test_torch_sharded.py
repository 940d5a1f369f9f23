"""PyTorch port, the title-sharded mesh (``parallel/sharded.py``): retrieval,
the mesh-built index and its checkpoint, the row-parallel engines and the
cascade, against the port's single device and the JAX package's mesh.

The worlds are ``tests/test_parallel.py``'s (600 titles, ``title_block``
128, ``query_block`` 8; ``world_small`` for the cascade).  The port's mesh is
``make_mesh(n, platform="cpu")``: n entries of the CPU, the counterpart of
the conftest's eight virtual CPU devices, on which the JAX mesh runs.
Tolerances:

- the port's mesh against its single device: **bit for bit** (scores,
  positions, ties included, and the index's every field); the cascade's
  ids and stages equal, predictions to 1e-6 (on the CPU an elementwise
  kernel such as ``torch.sigmoid`` rounds an array's vectorized body and
  its tail apart, and a shard's rows sit elsewhere in its arrays; on the
  card the tests of ``tests/test_torch_cuda.py`` hold them bit for bit);
- against the JAX mesh (window select through ``pallas_interpret``):
  scores to rtol 1e-6 and positions equal on untied slots; the mesh-built
  index's ``df`` equal, ``idf`` and ``sums`` to 1e-6 and 1e-5 (the JAX
  mesh sums in f32 on the device); the cascade as
  ``compare_predictions``.
"""

import logging
import random
import string

import numpy as np
import pytest
import torch

from doppelspeller_tpu.config import Config as JConfig
from doppelspeller_tpu.models.gbt import GBTModel as JGBTModel
from doppelspeller_tpu.ops.ngram_index import build_truth_index as jbuild_truth_index
from doppelspeller_tpu.parallel import sharded as jsharded
from doppelspeller_tpu.pipeline import Matcher as JMatcher
from doppelspeller_tpu.utils.io import TitleSet as JTitleSet
from doppelspeller_tpu.utils.misspell import generate_misspelled_name
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import TruthIndex, build_truth_index
from doppelspeller_tpu_torch.parallel.sharded import (
    Mesh,
    ShardedJaccardScorer,
    build_sharded_index,
    make_mesh,
)
from doppelspeller_tpu_torch.pipeline import Matcher
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import MODEL, compare_predictions, port_config, untied


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
    """``tests/test_parallel.py``'s world on both sides: (JAX config, truth,
    queries, index, port config, truth, queries, index)."""
    rng = random.Random(9)
    jcfg = JConfig(data_path="/tmp/x", title_block=128, query_block=8, score_dtype="float32")
    jtruth = JTitleSet.from_titles(_titles(600, rng), config=jcfg)
    jq = JTitleSet.from_titles(_titles(33, rng) + [jtruth.transformed[4]], config=jcfg)
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    queries = TitleSet.from_titles(jq.titles, ids=jq.ids, config=cfg)
    return (jcfg, jtruth, jq, jbuild_truth_index(jtruth, jcfg),
            cfg, truth, queries, build_truth_index(truth, cfg))


def _cpu_mesh(n):
    return make_mesh(n, platform="cpu")


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


# --------------------------------------------------------------------- mesh

def test_make_mesh_counts_cpu_entries_and_refuses_missing_cards():
    mesh = _cpu_mesh(8)
    assert mesh.size == len(jsharded.make_mesh(8, platform="cpu").devices.flat) == 8
    assert mesh.distinct == (torch.device("cpu"),) and mesh.axis == "titles"
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {have + 1} devices, have {have}"):
        make_mesh(have + 1)
    assert make_mesh(2, axis="data", platform="cpu").axis == "data"
    with pytest.raises(ValueError):
        Mesh(())


# ---------------------------------------------------------------- retrieval

@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window_select", [True, False])
def test_exact_mesh_is_the_single_device_bit_for_bit(world, n_dev, score_dtype, window_select):
    *_, cfg, truth, queries, index = world
    cfg = cfg.with_(score_dtype=score_dtype, retrieval_window_select=window_select)
    single = JaccardScorer(index, cfg, "cpu").topk(queries, k=15)
    mesh = ShardedJaccardScorer(index, _cpu_mesh(n_dev), cfg)
    assert mesh.exact is not None and len(mesh.exact) == n_dev and mesh.ntp_local == 1024 // n_dev
    _equal(single, mesh.topk(queries, k=15))


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_exact_mesh_matches_the_jax_mesh(world, n_dev, score_dtype):
    jcfg, _jt, jq, jindex, cfg, _t, queries, index = world
    jcfg = jcfg.with_(retrieval_impl="pallas_interpret", topk_recall_target=1.0,
                      score_dtype=score_dtype)
    sj, pj = jsharded.ShardedJaccardScorer(jindex, jsharded.make_mesh(n_dev), jcfg).topk(jq, k=15)
    sp, pp = ShardedJaccardScorer(index, _cpu_mesh(n_dev), port_config(jcfg)).topk(queries, k=15)
    np.testing.assert_allclose(sp, sj, rtol=1e-6, atol=1e-7)
    sep = untied(sj)
    assert sep.sum() > 100
    np.testing.assert_array_equal(pp[sep], pj[sep])


@pytest.mark.parametrize("window_select", [True, False])
def test_ties_across_shard_boundaries_keep_the_single_device_order(world, window_select):
    """Copies of titles on both sides of every boundary of a 4-shard mesh
    (256-title shards): the tied copies keep the single device's order."""
    *_, cfg, truth, _q, _i = world
    titles = list(truth.titles)
    for b in (256, 512):
        for j in range(6):
            titles[b + j] = titles[b - 6 + j]
    truth2 = TitleSet.from_titles(titles, config=cfg)
    queries = TitleSet.from_titles([titles[b - 6 + j] for b in (256, 512) for j in range(6)]
                                   + [titles[b - 6 + j][:-2] for b in (256, 512) for j in range(6)],
                                   config=cfg)
    cfg = cfg.with_(retrieval_window_select=window_select)
    index = build_truth_index(truth2, cfg)
    single = JaccardScorer(index, cfg, "cpu").topk(queries, k=10)
    mesh = ShardedJaccardScorer(index, _cpu_mesh(4), cfg).topk(queries, k=10)
    _equal(single, mesh)
    assert (single[0][:12, 0] == single[0][:12, 1]).all()                  # really tied


@pytest.fixture(scope="module")
def folded_world(world):
    """``tests/test_parallel.py``'s ``world_folded``: the exact scores and
    the injective-fold config (fold_dim >= the observed trigrams)."""
    *_, cfg, truth, queries, index = world
    assert int((index.df > 0).sum()) <= 8192
    cfg_inj = cfg.with_(retrieval_mode="folded", fold_dim=8192, rescore_depth=32)
    exact = JaccardScorer(index, cfg.with_(retrieval_mode="exact"), "cpu").topk(queries, k=15)
    return cfg, cfg_inj, truth, queries, index, exact


def test_folded_mesh_on_an_injective_fold_is_single_and_exact(folded_world):
    cfg, cfg_inj, truth, queries, index, (vs_e, ps_e) = folded_world
    mesh = ShardedJaccardScorer(index, _cpu_mesh(8), cfg_inj, truth=truth)
    assert mesh.folded is not None and mesh.exact is None
    assert len({e.ltw for e in mesh.folded}) == 1
    s2, p2 = mesh.topk(queries, k=15)
    s1, p1 = JaccardScorer(index, cfg_inj, "cpu", truth).topk(queries, k=15)
    np.testing.assert_array_equal(s1, s2)
    sep = untied(s1)
    np.testing.assert_array_equal(p1[sep], p2[sep])
    np.testing.assert_allclose(s2, vs_e, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(p2[sep & untied(vs_e)], ps_e[sep & untied(vs_e)])


def test_lossy_folded_mesh_dominates_the_single_device(folded_world):
    """Each shard rescores its own coarse top-k', a superset of the single
    engine's coarse candidates: every row's i-th score is at least the
    single engine's, and every strong exact candidate survives."""
    cfg, _inj, truth, queries, index, (vs_e, _ps) = folded_world
    cfgl = cfg.with_(retrieval_mode="folded", fold_dim=256, rescore_depth=64)
    s_mesh, _ = ShardedJaccardScorer(index, _cpu_mesh(8), cfgl, truth=truth).topk(queries, k=15)
    s_one, _ = JaccardScorer(index, cfgl, "cpu", truth).topk(queries, k=15)
    assert (s_mesh >= s_one).all()
    strong = vs_e >= 0.15
    assert strong.any()
    assert float(np.where(strong, vs_e - s_mesh, 0.0).max()) < 1e-6


def test_folded_mesh_honours_retrieval_mode(folded_world):
    cfg, cfg_inj, truth, _q, index, _e = folded_world
    mesh = _cpu_mesh(4)
    assert ShardedJaccardScorer(index, mesh, cfg.with_(retrieval_mode="exact"), truth=truth).folded is None
    assert ShardedJaccardScorer(index, mesh, cfg, truth=truth).folded is None     # auto, < 200k
    assert ShardedJaccardScorer(index, mesh, cfg.with_(folded_min_titles=500), truth=truth).folded
    with pytest.raises(ValueError, match="truth TitleSet"):
        ShardedJaccardScorer(index, mesh, cfg_inj)
    with pytest.raises(ValueError, match="per-shard"):
        ShardedJaccardScorer(index, _cpu_mesh(8), cfg_inj, truth=truth).topk(_q, k=129)


def test_probe_reads_the_merged_candidates(world):
    *_, cfg, truth, queries, index = world
    mesh = ShardedJaccardScorer(index, _cpu_mesh(4), cfg)
    t_len = torch.from_numpy(truth.lengths.astype(np.int64))
    t_wlen = torch.arange(len(truth))
    v, p, probe = mesh.topk_device(queries, k=15, probe_tables=(t_len, t_wlen))
    np.testing.assert_array_equal(probe[:, 0].numpy(), truth.lengths[p.numpy()].max(axis=1))
    np.testing.assert_array_equal(probe[:, 1].numpy(), p.numpy().max(axis=1))


# ----------------------------------------------------- index and checkpoint

def test_mesh_built_index_is_build_truth_index_and_the_jax_mesh_build(world):
    _jc, jtruth, _jq, _ji, cfg, truth, queries, index = world
    built = build_sharded_index(truth, _cpu_mesh(8), cfg)
    for f in ("idf", "df", "sums", "title_ids", "trigrams"):
        _equal([getattr(built.index, f)], [getattr(index, f)])
    for f in ("num_titles", "padded_titles", "max_idf", "content_hash"):
        assert getattr(built.index, f) == getattr(index, f)
    _equal(JaccardScorer(index, cfg, "cpu").topk(queries, k=15), built.topk(queries, k=15))
    jbuilt = jsharded.build_sharded_index(jtruth, jsharded.make_mesh(8), _jc)
    np.testing.assert_array_equal(built.index.df, jbuilt.index.df)
    np.testing.assert_allclose(built.index.idf, jbuilt.index.idf, rtol=1e-6)
    np.testing.assert_allclose(built.index.sums, jbuilt.index.sums, rtol=1e-5, atol=1e-5)


def test_checkpoint_saved_on_four_shards_loads_on_two_and_one(world, tmp_path):
    *_, cfg, truth, queries, index = world
    path = str(tmp_path / "index.npz")
    four = build_sharded_index(truth, _cpu_mesh(4), cfg)
    four.save(path)
    ref = four.topk(queries, k=15)
    two = ShardedJaccardScorer.load(path, _cpu_mesh(2), cfg)
    assert two.ntp_local == 384                 # 640 titles padded to 2 x 384
    _equal(ref, two.topk(queries, k=15))
    _equal(ref, ShardedJaccardScorer.load(path, _cpu_mesh(1), cfg).topk(queries, k=15))
    _equal(ref, JaccardScorer(TruthIndex.load(path), cfg, "cpu").topk(queries, k=15))
    assert ShardedJaccardScorer.checkpoint_matches(path, truth)
    other = TitleSet.from_titles(list(truth.titles[:-1]) + ["zz brand new co"], config=cfg)
    assert not ShardedJaccardScorer.checkpoint_matches(path, other)
    assert not ShardedJaccardScorer.checkpoint_matches(str(tmp_path / "missing.npz"), truth)


def test_matcher_on_a_mesh_resumes_from_the_checkpoint(world, tmp_path, caplog):
    *_, cfg, truth, queries, _index = world
    cfg = cfg.with_(data_path=str(tmp_path))
    built = build_sharded_index(truth, _cpu_mesh(8), cfg)
    built.save(cfg.index_path)
    with caplog.at_level(logging.INFO, logger="doppelspeller_tpu_torch"):
        m = Matcher(cfg, truth, mesh=_cpu_mesh(8))
    assert any("onto the mesh" in r.message for r in caplog.records)
    _equal(built.topk(queries, k=15), m.scorer.topk(queries, k=15))
    truth2 = TitleSet.from_titles(list(truth.titles) + ["zz brand new co"], config=cfg)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="doppelspeller_tpu_torch"):
        m2 = Matcher(cfg, truth2, mesh=_cpu_mesh(8))
    assert any("does not match" in r.message for r in caplog.records)
    assert m2.index.num_titles == len(truth2)


def test_a_jax_checkpoint_is_rebuilt_on_the_mesh_with_a_warning(world, tmp_path, caplog):
    jcfg, jtruth, _jq, _ji, cfg, truth, queries, index = world
    cfg = cfg.with_(data_path=str(tmp_path))
    jsharded.build_sharded_index(jtruth, jsharded.make_mesh(4), jcfg).save(cfg.index_path)
    with caplog.at_level(logging.WARNING, logger="doppelspeller_tpu_torch"):
        m = Matcher(cfg, truth, mesh=_cpu_mesh(4))
    text = caplog.text
    assert "is not a doppelspeller_tpu_torch.TruthIndex/1 checkpoint" in text
    assert "rebuilding on the mesh" in text
    _equal(JaccardScorer(index, cfg, "cpu").topk(queries, k=15), m.scorer.topk(queries, k=15))


# ------------------------------------------------------ engines and cascade

@pytest.fixture(scope="module")
def world_small():
    """``tests/test_parallel.py``'s ``world_small`` (220 titles, k = 15), on
    both sides, with the committed smoke model in place of a JAX-trained
    one (the model is an input here)."""
    rng = random.Random(21)
    jcfg = JConfig(data_path="/tmp/x_mesh", title_block=128, query_block=8, score_dtype="float32",
                   pair_block=64, top_n_predicting=15, top_n_training=5,
                   gbt_num_boost_round=25, gbt_early_stopping_rounds=25,
                   retrieval_impl="pallas_interpret")

    def words(n):
        return " ".join("".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(3, 8)))
                        for _ in range(n))

    truth_titles = [words(rng.randint(2, 3)) for _ in range(220)]
    jtruth = JTitleSet.from_titles(truth_titles, ids=np.arange(500, 720), config=jcfg)
    for i in range(50):                              # the fixture's train draws
        generate_misspelled_name(jtruth.transformed[i], rng)
    for _ in range(25):
        words(3)
    test_titles = ([jtruth.titles[i] for i in range(100, 112)]
                   + [generate_misspelled_name(jtruth.transformed[i], rng) for i in range(112, 150)]
                   + [words(3) for _ in range(14)])
    jtest = JTitleSet.from_titles(test_titles, ids=np.arange(len(test_titles)), config=jcfg)
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(truth_titles, ids=jtruth.ids, config=cfg)
    test = TitleSet.from_titles(test_titles, ids=jtest.ids, config=cfg)
    return jcfg, jtruth, jtest, cfg, truth, test


def test_row_parallel_engines_decide_as_one_device(world_small):
    *_, cfg, truth, test = world_small
    model = GBTModel.load(str(MODEL))
    one = Matcher(cfg, truth, model, device="cpu", use_index_checkpoint=False)
    mesh = Matcher(cfg, truth, model, mesh=_cpu_mesh(3), use_index_checkpoint=False)
    assert set(mesh._fuzzy_copies) == {torch.device("cpu")}
    rng = np.random.default_rng(0)
    cand = torch.from_numpy(rng.integers(0, len(truth), (len(test), 15)).astype(np.int32))
    q = [torch.from_numpy(np.ascontiguousarray(x[:, :64])) if x.ndim == 2 else torch.from_numpy(x)
         for x in (test.encoded, test.lengths, *test.encoded_token_sorted)]
    f1 = one._decide(one.fuzzy, None, *q, cand, tl=64)
    f2 = mesh._decide(mesh.fuzzy, mesh._fuzzy_copies, *q, cand, tl=64)
    _equal([x.numpy() for x in f1], [x.numpy() for x in f2])
    wo, wo_len = test.encoded_wo
    r = [torch.from_numpy(np.ascontiguousarray(x)) for x in (test.encoded, test.lengths, wo, wo_len)]
    for narrow, col_lo in ((0, 0), (5, 0), (0, 5)):
        kw = dict(tl=64, wl=16, narrow=narrow, col_lo=col_lo)
        c1, p1, m1 = one._decide(one.rerank, None, *r, cand, **kw)
        c2, p2, m2 = mesh._decide(mesh.rerank, mesh._rerank_copies, *r, cand, **kw)
        _equal([c1.numpy(), p1.numpy()], [c2.numpy(), p2.numpy()])
        np.testing.assert_allclose(m1.numpy(), m2.numpy(), rtol=1e-6)


@pytest.mark.parametrize("cascade_impl", ["device", "auto"])
def test_matcher_on_a_mesh_predicts_as_one_device_and_the_jax_mesh(world_small, cascade_impl):
    jcfg, jtruth, jtest, cfg, truth, test = world_small
    jcfg, cfg = jcfg.with_(cascade_impl=cascade_impl), cfg.with_(cascade_impl=cascade_impl)
    model = GBTModel.load(str(MODEL))
    mesh = Matcher(cfg, truth, model, mesh=_cpu_mesh(8), use_index_checkpoint=False)
    assert not mesh._use_fused(np.arange(3), "auto")
    rp = mesh.predict(test)
    r1 = Matcher(cfg, truth, model, device="cpu", use_index_checkpoint=False).predict(test)
    compare_predictions(r1, rp)
    np.testing.assert_allclose(r1.prediction, rp.prediction, rtol=1e-6)
    assert all(rp.stage_counts[s] > 0 for s in ("exact", "fuzzy", "model"))
    if cascade_impl == "device":
        rj = JMatcher(jcfg, truth=jtruth, model=JGBTModel.load(str(MODEL)),
                      use_index_checkpoint=False,
                      mesh=jsharded.make_mesh(8, axis="titles", platform="cpu")).predict(jtest)
        compare_predictions(rj, rp)
    single = mesh.predict(TitleSet.from_titles([test.titles[20]], config=cfg), single=True)
    ref = Matcher(cfg, truth, model, device="cpu", use_index_checkpoint=False).predict(
        TitleSet.from_titles([test.titles[20]], config=cfg), single=True)
    a, b = single.single_result(), ref.single_result()
    assert a.pop("prediction") == pytest.approx(b.pop("prediction"), rel=1e-6) and a == b
