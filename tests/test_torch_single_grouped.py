"""PyTorch port, one device run as the JAX package runs one device: retrieval
in groups of ``dispatch_blocks`` query blocks (one upload a group, a graph
a (k, block shape) on a card), and the fuzzy and model stages in runs of rows
padded to fixed shapes (``pipeline.Matcher._decide`` through
``parallel/workers.py``'s ``row_parallel``).

On the CPU ``tests.test_torch_helpers.EagerGraphs`` stands in for the
card's graphs (a capture runs the step on copies of its inputs, a replay
copies new rows into their leading rows and runs it again), so the
padding, keys, replays and cuts run here, and so does the rule that a key
runs op by op through the first run (a predict, or a call alone) that
uses it and is captured in the next.  Grouped retrieval is held
**bit for bit** to the block-by-block loop it replaced, written out here
as the reference; the padded stages bit for bit to the engines on the
unpadded rows.  Against the JAX package: the exact scorer (window select
through ``pallas_interpret``) to rtol 1e-6 with positions equal on untied
slots, as ``tests/test_torch_mesh_concurrent.py`` holds the mesh; the
predict as ``tests/test_torch_pipeline.py`` holds it (stages and ids
equal, predictions to 1e-5).
"""

import random
import string
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from doppelspeller_tpu.config import Config as JConfig
from doppelspeller_tpu.models.gbt import GBTModel as JGBTModel
from doppelspeller_tpu.ops.jaccard import JaccardScorer as JScorer
from doppelspeller_tpu.ops.ngram_index import build_truth_index as jbuild_truth_index
from doppelspeller_tpu.pipeline import Matcher as JMatcher
from doppelspeller_tpu.utils.io import TitleSet as JTitleSet
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.ops.fold import plan_id_blocks
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index, plan_query_blocks
from doppelspeller_tpu_torch.parallel.workers import Mesh
from doppelspeller_tpu_torch.pipeline import Matcher
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import MODEL, EagerGraphs, compare_predictions, port_config, untied

CPU = torch.device("cpu")


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
def grouped():
    """600 titles (``title_block`` 128, ``query_block`` 8) and 70 queries, 9
    blocks, the last of 6 rows; on both sides: (JAX config, truth, queries,
    index, port config, truth, queries, index)."""
    rng = random.Random(15)
    jcfg = JConfig(data_path="/tmp/x_single", title_block=128, query_block=8, score_dtype="float32")
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
    """The loop the groups replaced: each plan's block through the engine,
    its valid rows concatenated in order."""
    vals, pos = [], []
    if sc.exact is not None:
        for p in plan_query_blocks(queries, sc.index, sc.cfg):
            v, ps = sc.exact.topk_block(p, k)
            vals.append(v[: p.n_valid])
            pos.append(ps[: p.n_valid])
    else:
        for p in plan_id_blocks(queries, sc.cfg):
            v, ps = sc.folded.topk_block(torch.from_numpy(p.ids).to(torch.int64), k)
            vals.append(v[: p.n_valid])
            pos.append(ps[: p.n_valid])
    return torch.cat(vals).numpy(), torch.cat(pos).numpy()


MODES = {
    "exact": dict(retrieval_mode="exact"),
    "folded": dict(retrieval_mode="folded", fold_dim=256, rescore_depth=32),
}


@pytest.mark.parametrize("dispatch_blocks", [1, 2, 32])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_grouped_topk_is_the_block_by_block_result(grouped, mode, dispatch_blocks):
    """Groups of 1, 2 (a ragged last group) and 32 blocks (one group): one
    issue on the worker a group, the block-by-block result bit for bit,
    op by op and through the (eager) graphs, twice: the first call op by
    op, the second a capture at each block shape's first block and a
    replay at every other."""
    *_, cfg, truth, queries, index = grouped
    cfg = cfg.with_(dispatch_blocks=dispatch_blocks, **MODES[mode])
    sc = JaccardScorer(index, cfg, "cpu", truth)
    assert (sc.folded is not None) == (mode == "folded")
    ref = _block_by_block(sc, queries, 12)
    shapes = Counter(p.ids.shape if mode == "folded" else (p.union_ids.shape[0],) + p.w_pos.shape
                     for p in (plan_id_blocks(queries, cfg) if mode == "folded"
                               else plan_query_blocks(queries, index, cfg)))
    n_blocks = sum(shapes.values())
    for workers in (sc.workers, EagerGraphs(Mesh((CPU,)))):
        sc.workers = workers
        seen = []
        real = workers.submit
        workers.submit = lambda job, shards=None: seen.append(threading.get_ident()) or real(job, shards)
        for _ in range(2):
            _equal(ref, sc.topk(queries, k=12))
        assert len(seen) == 2 * -(-n_blocks // dispatch_blocks)      # one issue a group
        sc.close()
    assert {key for _, key in workers.graphs} == {("topk", 12) + tuple(shape) for shape in shapes}
    assert workers.captures["topk"] == [len(shapes)]
    assert workers.replays["topk"] == [n_blocks - len(shapes)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_grouped_topk_keys_its_graphs_by_k(grouped, mode):
    """One scorer asked for k = 12, then k = 5, each twice, through the
    (eager) graphs: each k has graphs of its own and every call is the
    block-by-block result at its k."""
    *_, cfg, truth, queries, index = grouped
    cfg = cfg.with_(dispatch_blocks=2, **MODES[mode])
    sc = JaccardScorer(index, cfg, "cpu", truth)
    sc.workers = EagerGraphs(Mesh((CPU,)))
    for k in (12, 12, 5, 5):
        _equal(_block_by_block(sc, queries, k), sc.topk(queries, k=k))
    assert {key[1] for _, key in sc.workers.graphs} == {12, 5}
    sc.close()


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_grouped_exact_topk_is_the_jax_scorer(grouped, score_dtype):
    jcfg, _jt, jq, jindex, _cfg, _t, queries, index = grouped
    jcfg = jcfg.with_(retrieval_impl="pallas_interpret", topk_recall_target=1.0,
                      score_dtype=score_dtype, dispatch_blocks=2, retrieval_mode="exact")
    sj, pj = JScorer(jindex, jcfg).topk(jq, k=15)
    sc = JaccardScorer(index, port_config(jcfg), "cpu")
    sc.workers = EagerGraphs(Mesh((CPU,)))
    sp, pp = sc.topk(queries, k=15)
    np.testing.assert_allclose(sp, sj, rtol=1e-6, atol=1e-7)
    sep = untied(sj)
    assert sep.sum() > 300
    np.testing.assert_array_equal(pp[sep], pj[sep])
    sc.close()


@pytest.fixture(scope="module")
def matcher(grouped):
    *_, cfg, truth, queries, _index = grouped
    m = Matcher(cfg.with_(top_n_predicting=15), truth, GBTModel.load(str(MODEL)), device="cpu",
                use_index_checkpoint=False)
    yield m, queries
    m.close()


@pytest.mark.parametrize("n_rows", [1, 63, 64, 65, 300])
@pytest.mark.parametrize("stage", ["fuzzy", "model"])
def test_padded_decide_is_the_unpadded_rows(matcher, stage, n_rows):
    """A run of ``n_rows`` rows, then of half of them, each three times,
    through ``Matcher._decide`` on one device's (eager) graphs: a padded
    shape (a power of two of at least 64 rows) run op by op on the rows
    alone in its first call, captured in its second (the fuzzy stage in its
    static form), replayed into its leading rows after that, and cut back;
    every run equal to the engine on the rows alone (the fuzzy stage in
    its dynamic form)."""
    m, queries = matcher
    rng = np.random.default_rng(n_rows)
    idx = rng.integers(0, len(queries), n_rows)
    cand = torch.from_numpy(rng.integers(0, len(m.truth), (n_rows, 15)).astype(np.int32))
    tl = 64
    if stage == "fuzzy":
        ts, ts_len = queries.encoded_token_sorted
        rows = [torch.from_numpy(np.ascontiguousarray(x)) for x in
                (queries.encoded[idx, :tl], queries.lengths[idx], ts[idx, :tl], ts_len[idx])]
        engine, kw = m.fuzzy, dict(tl=tl)
    else:
        wo, wo_len = queries.encoded_wo
        rows = [torch.from_numpy(np.ascontiguousarray(x[idx])) for x in
                (queries.encoded, queries.lengths, wo, wo_len)]
        engine, kw = m.rerank, dict(tl=tl, wl=16, narrow=5, col_lo=2)
    want = engine.decide(*rows, cand, **kw)
    workers = m.scorer.workers
    m.scorer.workers = graphed = EagerGraphs(Mesh((CPU,)))
    half = n_rows // 2 or 1
    try:
        runs = [(m._decide(engine, None, *(x[:n] for x in rows), cand[:n], **kw), n)
                for n in (n_rows,) * 3 + (half,) * 3]
    finally:
        m.scorer.workers = workers
    for got, n in runs:
        if stage == "fuzzy":
            _equal([x[:n].numpy() for x in want], [x.numpy() for x in got])
        else:
            # counts and positions bit for bit; the probabilities to rtol
            # 1e-6, as tests/test_torch_sharded.py holds a mesh's rows: on
            # the CPU an elementwise op's vector loop and its scalar tail
            # round transcendentals apart, and padding moves rows between
            # them (on the card, tests/test_torch_cuda.py: bit for bit)
            _equal([x[:n].numpy() for x in want[:2]], [x.numpy() for x in got[:2]])
            np.testing.assert_allclose(got[2].numpy(), want[2][:n].numpy(), rtol=1e-6)
    pads = {max(64, 1 << (n - 1).bit_length()) for n in (n_rows, half)}
    name = type(engine).__name__
    settings = tuple(sorted((dict(kw, static=True) if stage == "fuzzy" else kw).items()))
    assert {key[: len(settings) + 2] for _, key in graphed.graphs} == {
        (name,) + settings + (pad,) for pad in pads}
    assert graphed.captures[name] == [len(pads)]
    assert graphed.replays.get(name, [0]) == [6 - 2 * len(pads)]


def test_predict_through_the_graphed_path_is_the_jax_predict(world):
    """The conftest world under the device cascade (folded retrieval, f32,
    ``model_depth_initial`` 8 of 20 candidates and every untrusted row
    widened, so both model waves run):
    the port's predicts through one device's (eager) graphs, the first (op
    by op), the second (every key captured) and the third (every stage's
    graphs replayed), equal the JAX ``Matcher.predict``, and the port's
    op-by-op predict bit for bit."""
    jcfg, jtruth, _train, jtest, actual = world
    jcfg = jcfg.with_(cascade_impl="device", retrieval_mode="folded", fold_hashes=2,
                      retrieval_impl="pallas_interpret", score_dtype="float32",
                      model_depth_initial=8, model_widen_threshold=0.0, dispatch_blocks=2)
    rj = JMatcher(jcfg, truth=jtruth, model=JGBTModel.load(str(MODEL)),
                  use_index_checkpoint=False).predict(jtest)
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    test = TitleSet.from_titles(jtest.titles, ids=jtest.ids, config=cfg)
    m = Matcher(cfg, truth=truth, model=GBTModel.load(str(MODEL)), device="cpu")
    eager = m.predict(test)
    m.scorer.workers = graphed = EagerGraphs(Mesh((CPU,)))
    for _ in range(3):
        rp = m.predict(test)
        compare_predictions(rj, rp)
        for name in ("match_title_id", "prediction", "stage"):
            _equal([getattr(eager, name)], [getattr(rp, name)])
    assert all(rp.stage_counts[s] > 0 for s in ("exact", "fuzzy", "model"))
    assert (rp.match_title_id == actual).mean() > 0.8
    waves = {dict(key[1:5])["col_lo"] for _, key in graphed.graphs if key[0] == "RerankEngine"}
    assert waves == {0, cfg.model_depth_initial}                   # waves A and B, as graphs
    assert all(graphed.replays[name] for name in ("topk", "FuzzyEngine", "RerankEngine"))
    m.close()
