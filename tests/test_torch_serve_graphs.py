"""PyTorch port: the one-dispatch path's graphs on the scorer's ``Workers``.

On the CPU ``tests.test_torch_helpers.EagerGraphs`` stands in for the
card's graphs, so the one-dispatch path's keys, its capture at a key's
first request and its replays run here, on both retrieval engines: a
graphed request equals the same request run op by op bit for bit, the
predicts through the graphs equal the op-by-op path's and the staged
path's, ``Matcher.set_model`` leaves no graph of the old model, and
``use_graphs = False`` captures nothing.  The matchers take 8-query blocks
(the serve loop's latency profile) on a 4,096-title world, with torch on one
thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.parallel.workers import Mesh
from doppelspeller_tpu_torch.pipeline import STAGE_EXACT, STAGE_FUZZY, STAGE_MODEL, STAGE_NONE, Matcher
from doppelspeller_tpu_torch.synthetic import make_synthetic_world
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import MODEL, EagerGraphs, compare_predictions

CPU = torch.device("cpu")
MODES = ["exact", "folded"]
KINDS = ["exact", "fuzzy", "model", "below_threshold", "batch8"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def serve_world():
    cfg, truth, queries, _ = make_synthetic_world(4096, 256, config=Config(data_path="data"))
    return cfg, truth, queries


def _matcher(serve_world, mode, graphs=True, model=None, **kw):
    cfg, truth, _ = serve_world
    m = Matcher(cfg.with_(**{"retrieval_mode": mode, "query_block": 8, **kw}), truth,
                model or GBTModel.load(str(MODEL)), device="cpu", use_index_checkpoint=False)
    if graphs:
        m.scorer.workers = EagerGraphs(Mesh((CPU,)))
    return m


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint8)


def _same(a, b):
    """Two results of the one-dispatch path, bit for bit."""
    for name in ("match_title_id", "stage", "prediction"):
        assert np.array_equal(_bits(getattr(a, name)), _bits(getattr(b, name))), name
    assert a.match_transformed == b.match_transformed and a.stage_counts == b.stage_counts


def _fused_graphs(workers):
    return [key for _, key in workers.graphs if key[0] == "FusedServe"]


@pytest.mark.parametrize("mode", MODES)
def test_fused_capture_then_replay_equals_op_by_op(serve_world, mode):
    """A key's first request captures it and answers with the warm-up; a
    second request of the same key replays it; both equal the same request
    through ``dispatch(..., eager=True)`` bit for bit."""
    _cfg, _truth, queries = serve_world
    m = _matcher(serve_world, mode)
    fs, w = m._fused_engine(), m.scorer.workers
    assert fs.mode == mode and fs.qb == 8
    blocks = [TitleSet.from_titles(queries.titles[s : s + 8], config=m.cfg) for s in range(0, 256, 8)]
    keys = [fs.request(b, np.arange(8))[1] for b in blocks]
    again = next(b for b, k in zip(blocks[1:], keys[1:]) if k == keys[0])
    assert keys[0][:2] == ("FusedServe", mode)
    for n, block in enumerate((blocks[0], again)):
        got = fs.dispatch(block, np.arange(8))
        assert w.captures == {"FusedServe": [1]} and w.replays.get("FusedServe", [0]) == [n]
        ref = fs.dispatch(block, np.arange(8), eager=True)
        assert np.array_equal(got[0], ref[0]) and got[3] == ref[3]
        assert np.array_equal(_bits(got[1]), _bits(ref[1])) and np.array_equal(got[2], ref[2])
    assert _fused_graphs(w) == [keys[0]]
    assert w.captures == {"FusedServe": [1]} and w.replays == {"FusedServe": [1]}


@pytest.fixture(scope="module", params=MODES)
def answered(serve_world, request):
    """(mode, graphed matcher, op-by-op matcher, staged matcher, the first
    64 queries as the staged path decides them)."""
    _cfg, _truth, queries = serve_world
    mode = request.param
    off = _matcher(serve_world, mode, graphs=False, serve_fused="off")
    first = TitleSet.from_titles(queries.titles[:64], ids=queries.ids[:64], config=off.cfg)
    return (mode, _matcher(serve_world, mode), _matcher(serve_world, mode, graphs=False), off,
            off.predict(first))


@pytest.mark.parametrize("kind", KINDS)
def test_fused_graphs_answer_as_op_by_op_and_staged(serve_world, answered, kind):
    """Single titles the stages decide (one an exact copy, one a fuzzy
    match, one the model's, one under the probability threshold that a
    single title still answers) and a batch of 8: the graphed path's
    predicts, at the key's capture and at its replay, equal the op-by-op
    path's bit for bit and the staged path's (``serve_fused="off"``)."""
    _cfg, _truth, queries = serve_world
    _mode, graphed, eager, off, first = answered
    if kind == "batch8":
        titles, single = queries.titles[:8], False
    else:
        stage = {"exact": STAGE_EXACT, "fuzzy": STAGE_FUZZY, "model": STAGE_MODEL,
                 "below_threshold": STAGE_NONE}[kind]
        titles, single = [queries.titles[int(np.flatnonzero(first.stage == stage)[0])]], True
    qs = TitleSet.from_titles(titles, ids=np.arange(len(titles)), config=graphed.cfg)
    want = eager.predict(qs, single=single)
    w = graphed.scorer.workers
    replays = sum(w.replays.get("FusedServe", [0]))
    for _ in range(2):
        got = graphed.predict(qs, single=single)
        _same(got, want)
        compare_predictions(off.predict(qs, single=single), got)
    if kind == "exact":
        assert got.stage[0] == STAGE_EXACT
    else:
        assert got.stage_seconds["fuzzy"] == got.stage_seconds["model"] == 0.0
        assert sum(w.replays["FusedServe"]) > replays
    if kind == "below_threshold":
        assert got.stage[0] == STAGE_MODEL
        assert got.prediction[0] <= graphed.cfg.prediction_probability_threshold
    if kind == "batch8":
        assert len(set(got.stage.tolist())) >= 3


def _mirrored(model: GBTModel) -> GBTModel:
    """Another model: every leaf value negated."""
    return dataclasses.replace(model, value=-model.value)


@pytest.mark.parametrize("mode", MODES)
def test_set_model_drops_the_fused_graphs(serve_world, mode):
    """``Matcher.set_model`` drops the one-dispatch graphs, which hold the
    old model: none is left, the next request captures again, and its
    answer is the new model's."""
    _cfg, _truth, queries = serve_world
    m = _matcher(serve_world, mode)
    qs = TitleSet.from_titles(queries.titles[8:16], ids=np.arange(8), config=m.cfg)
    before = m.predict(qs)
    w = m.scorer.workers
    assert len(_fused_graphs(w)) == 1
    other = _mirrored(m.model)
    m.set_model(other)
    assert not _fused_graphs(w)
    after = m.predict(qs)
    assert w.captures["FusedServe"] == [2] and len(_fused_graphs(w)) == 1
    _same(after, _matcher(serve_world, mode, graphs=False, model=other).predict(qs))
    assert np.isfinite(after.prediction).all()
    assert not np.array_equal(after.prediction, before.prediction)


@pytest.mark.parametrize("mode", MODES)
def test_a_rebuilt_fused_engine_drops_its_predecessors_graphs(serve_world, mode):
    """The one-dispatch program built again for other settings (16-query
    blocks, as a caller switching profiles does) drops the graphs its
    predecessor captured, whose keys do not hold the block: its requests
    capture their own and answer as the op-by-op path at 16."""
    _cfg, _truth, queries = serve_world
    m = _matcher(serve_world, mode)
    qs = TitleSet.from_titles(queries.titles[24:32], ids=np.arange(8), config=m.cfg)
    m.predict(qs)
    w = m.scorer.workers
    assert len(_fused_graphs(w)) == 1
    m.cfg, m._fused = m.cfg.with_(query_block=16), None
    assert m._fused_engine().qb == 16 and not _fused_graphs(w)
    got = m.predict(qs)
    assert w.captures["FusedServe"] == [2] and len(_fused_graphs(w)) == 1
    _same(got, _matcher(serve_world, mode, graphs=False, query_block=16).predict(qs))


@pytest.mark.parametrize("mode", MODES)
def test_use_graphs_false_captures_nothing(serve_world, mode):
    """Workers switched to op by op run the one-dispatch path op by op: no
    capture, no replay, the op-by-op path's answers."""
    _cfg, _truth, queries = serve_world
    m = _matcher(serve_world, mode)
    m.scorer.workers.use_graphs = False
    qs = TitleSet.from_titles(queries.titles[16:24], ids=np.arange(8), config=m.cfg)
    for _ in range(2):
        got = m.predict(qs)
    assert not m.scorer.workers.graphs and not m.scorer.workers.captures and not m.scorer.workers.replays
    _same(got, _matcher(serve_world, mode, graphs=False).predict(qs))
