"""PyTorch port, decide stages: forest inference, the model-stage decide and
the fuzzy decide, each against the JAX function on the same inputs (the
committed smoke model, the conftest ``world``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doppelspeller_tpu.models.gbt import GBTModel as JGBTModel
from doppelspeller_tpu.models.gbt import predict_forest_margin as j_margin
from doppelspeller_tpu.models.trainer import WordCounts as JWordCounts
from doppelspeller_tpu.ops.features import split_words_host as j_split_words
from doppelspeller_tpu.ops.fuzzy import FuzzyEngine as JFuzzyEngine
from doppelspeller_tpu.ops.rerank import RerankEngine as JRerankEngine
from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.models.gbt import GBTModel, predict_forest_margin
from doppelspeller_tpu_torch.models.trainer import WordCounts
from doppelspeller_tpu_torch.ops.features import remove_spaces_host, split_words_host
from doppelspeller_tpu_torch.ops.fuzzy import FuzzyEngine
from doppelspeller_tpu_torch.ops.rerank import RerankEngine
from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import MODEL, port_config


@pytest.fixture(scope="module")
def models():
    return JGBTModel.load(str(MODEL)), GBTModel.load(str(MODEL))


def test_model_loads_and_converts(models):
    jm, pm = models
    assert pm.num_trees == jm.num_trees and pm.depth == jm.depth
    conv = GBTModel.from_arrays(vars(jm))
    for f in ("feat", "threshold", "missing_left", "value", "is_leaf", "edges"):
        np.testing.assert_array_equal(getattr(conv, f), getattr(pm, f))
    assert (conv.base_score, conv.best_ntree_limit) == (pm.base_score, pm.best_ntree_limit)


def test_forest_margin_matches_jax(models):
    jm, pm = models
    rng = np.random.default_rng(0)
    B, F = 600, 66
    internal = jm.feat[:, : 2 ** jm.depth - 1]
    thr = jm.threshold[:, : 2 ** jm.depth - 1]
    X = rng.normal(size=(B, F)).astype(np.float32) * 20
    # put values on and around the split thresholds of the features used
    used = internal >= 0
    picks = rng.integers(0, used.sum(), size=(B, 40))
    fs, ts = internal[used][picks], thr[used][picks]
    jitter = rng.choice([-1e-3, 0.0, 0.0, 1e-3], size=ts.shape).astype(np.float32)
    X[np.arange(B)[:, None], fs] = ts + jitter
    X[rng.random((B, F)) < 0.1] = np.nan
    nt = jm.best_ntree_limit
    base = float(np.log(jm.base_score / (1 - jm.base_score)))
    ref = np.asarray(j_margin(jnp.asarray(X), jnp.asarray(jm.feat[:nt]), jnp.asarray(jm.threshold[:nt]),
                              jnp.asarray(jm.missing_left[:nt]), jnp.asarray(jm.value[:nt]),
                              jnp.asarray(jm.is_leaf[:nt]), jm.depth, base))
    arrays = pm.forest_arrays("cpu")
    got = predict_forest_margin(torch.from_numpy(X), *arrays, pm.depth, pm.base_margin).numpy()
    np.testing.assert_allclose(ref, got, atol=1e-5)
    assert np.std(ref) > 0.1


@pytest.fixture(scope="module")
def stage_inputs(world):
    jcfg, jtruth, _train, jtest, actual = world
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    test = TitleSet.from_titles(jtest.titles, ids=jtest.ids, config=cfg)
    rng = np.random.default_rng(7)
    R, K = len(test), 24
    cand = rng.integers(0, len(truth), (R, K)).astype(np.int32)
    pos_of = {int(i): p for p, i in enumerate(truth.ids)}
    for r, a in enumerate(actual):
        if a >= 0:
            cand[r, rng.integers(0, K)] = pos_of[int(a)]
    cand[::7, 5] = cand[::7, 3]                    # duplicated candidates: ties
    return jcfg, cfg, jtruth, truth, test, cand


def _bucket(n, buckets=(32, 64, 128, 255)):
    return next(b for b in buckets if n <= b)


@pytest.mark.parametrize("narrow,col_lo", [(0, 0), (8, 0), (0, 8)])
def test_rerank_decide_matches_jax(models, stage_inputs, narrow, col_lo):
    jm, pm = models
    jcfg, cfg, jtruth, truth, test, cand = stage_inputs
    words = split_words_host(truth.encoded, truth.lengths)
    counts = WordCounts(truth).matrix(truth.transformed)
    np.testing.assert_array_equal(counts, JWordCounts(jtruth).matrix(jtruth.transformed))
    je = JRerankEngine(jtruth.encoded, jtruth.lengths, j_split_words(jtruth.encoded, jtruth.lengths),
                       counts, jm, len(jtruth), jcfg)
    pe = RerankEngine(truth.encoded, truth.lengths, words, counts, pm, len(truth), cfg, "cpu")
    tl = _bucket(max(int(test.lengths.max()), int(truth.lengths.max())))
    wl = _bucket(int(words[1].max()), (16, 32, 64, 255))
    q_wo, q_wo_len = remove_spaces_host(test.encoded, test.lengths)
    R = len(test)
    jc, jp, jx = je.decide_device(test.encoded, test.lengths, q_wo, q_wo_len, jnp.asarray(cand),
                                  np.arange(R), tl, wl, narrow=narrow, col_lo=col_lo)
    pc, pp, px = pe.decide(torch.from_numpy(test.encoded[:, :tl]), torch.from_numpy(test.lengths),
                           torch.from_numpy(q_wo[:, :tl]), torch.from_numpy(q_wo_len),
                           torch.from_numpy(cand), tl, wl, narrow=narrow, col_lo=col_lo)
    np.testing.assert_array_equal(np.asarray(jc)[:R], pc.numpy())
    np.testing.assert_array_equal(np.asarray(jp)[:R], pp.numpy())
    np.testing.assert_allclose(np.asarray(jx)[:R], px.numpy(), atol=1e-6)
    assert (pc.numpy() > 1).any() and (px.numpy() > 0.9).any()


def test_fuzzy_decide_matches_jax(stage_inputs):
    jcfg, cfg, jtruth, truth, test, cand = stage_inputs
    ts = [" ".join(sorted(t.split())) for t in truth.transformed]
    ts_enc = T.encode_titles(ts)
    ts_len = np.array([len(s) for s in ts], np.int32)
    wlen_max = split_words_host(truth.encoded, truth.lengths)[1].max(axis=1).astype(np.int32)
    je = JFuzzyEngine(jtruth.encoded, jtruth.lengths, ts_enc, ts_len, jcfg, truth_wlen_max=wlen_max)
    pe = FuzzyEngine(truth.encoded, truth.lengths, ts_enc, ts_len, wlen_max, cfg, "cpu")
    q_ts, q_ts_len = test.encoded_token_sorted
    thr = cfg.levenshtein_ratio_threshold
    need = int(((test.lengths.astype(np.int64) * (200 - thr) + thr - 1) // thr).max())
    tl = _bucket(need)
    R = len(test)
    ref = je.decide_device(test.encoded, test.lengths, q_ts, q_ts_len, jnp.asarray(cand), np.arange(R), tl)
    got = pe.decide(torch.from_numpy(test.encoded[:, :tl]), torch.from_numpy(test.lengths),
                    torch.from_numpy(q_ts[:, :tl]), torch.from_numpy(q_ts_len), torch.from_numpy(cand), tl)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r)[:R], g.numpy())
    matched = got[0].numpy()
    assert matched.any() and (~matched).any()


def test_fuzzy_tile_cap_is_not_ported():
    """The engine takes ``fuzzy_tile_cap``: a row with a considered pair
    longer than the capped tile is flagged for the host redo (``over``),
    a row within it is not."""
    enc = np.zeros((2, 255), np.uint8)
    lens = np.array([40, 20], np.int32)
    enc[0, :40] = 3
    enc[1, :20] = 4
    engine = FuzzyEngine(enc, lens, enc, lens, np.ones(2, np.int32),
                         Config(data_path="/tmp/x", fuzzy_tile_cap=32), "cpu")
    q = torch.from_numpy(enc)
    ql = torch.from_numpy(lens)
    matched, _pos, _ratio, over, _ptl, _pwl = engine.decide(
        q, ql, q, ql, torch.tensor([[0, 1], [1, 0]], dtype=torch.int32), 32)
    assert over.tolist() == [True, False]
    assert matched[1]                 # row 0 was scored truncated: the host decides it
