"""PyTorch port, the exact retrieval path end to end: ``Matcher.predict``
against the JAX ``Matcher.predict`` (device cascade, exact union retrieval
with the Pallas kernels in interpret mode) with the committed smoke model.
``retrieval_mode="auto"`` resolves to the exact path below
``folded_min_titles`` titles; the oracle is the bench's exact-config anchor
(f32, full matrix and exact top-k, model depth 0)."""

import numpy as np
import pytest

import bench
from doppelspeller_tpu.models.gbt import GBTModel as JGBTModel
from doppelspeller_tpu.pipeline import Matcher as JMatcher
from doppelspeller_tpu_torch import synthetic
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.pipeline import STAGE_MODEL, Matcher
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import MODEL, compare_predictions, port_config

AUTO = dict(cascade_impl="device", retrieval_mode="auto", retrieval_impl="pallas_interpret",
            score_dtype="float32")
ORACLE = dict(AUTO, topk_recall_target=1.0, model_depth_initial=0,
              retrieval_window_select=False, retrieval_mode="exact")


def test_predict_auto_exact_matches_jax_on_world(world):
    jcfg, jtruth, _train, jtest, actual = world
    jcfg = jcfg.with_(**AUTO)
    rj = JMatcher(jcfg, truth=jtruth, model=JGBTModel.load(str(MODEL)),
                  use_index_checkpoint=False).predict(jtest)
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    test = TitleSet.from_titles(jtest.titles, ids=jtest.ids, config=cfg)
    matcher = Matcher(cfg, truth=truth, model=GBTModel.load(str(MODEL)), device="cpu")
    assert matcher.scorer.exact is not None and matcher.scorer.folded is None
    rp = matcher.predict(test)
    compare_predictions(rj, rp)
    assert all(rp.stage_counts[s] > 0 for s in ("exact", "fuzzy", "model"))
    assert (rp.match_title_id == actual).mean() > 0.8


@pytest.fixture(scope="module")
def world4096():
    jcfg, jtruth, jq, actual = bench.make_synthetic_world(4096, 512)
    jcfg = jcfg.with_(data_path="/tmp/doppel_tpu_test_data", top_n_predicting=100)
    cfg = port_config(jcfg)
    _, truth, queries, actual_p = synthetic.make_synthetic_world(4096, 512, config=cfg)
    np.testing.assert_array_equal(actual, actual_p)
    return jcfg, jtruth, jq, cfg, truth, queries, actual


def test_predict_auto_exact_matches_jax_with_waves(world4096, monkeypatch):
    jcfg, jtruth, jq, cfg, truth, queries, actual = world4096
    rj = JMatcher(jcfg.with_(**AUTO), truth=jtruth, model=JGBTModel.load(str(MODEL)),
                  use_index_checkpoint=False).predict(jq)
    matcher = Matcher(cfg.with_(**AUTO), truth=truth, model=GBTModel.load(str(MODEL)), device="cpu")
    assert matcher.scorer.exact is not None
    calls = []
    decide = matcher.rerank.decide

    def spy(*args, **kwargs):
        calls.append((kwargs.get("narrow", 0), kwargs.get("col_lo", 0)))
        return decide(*args, **kwargs)

    monkeypatch.setattr(matcher.rerank, "decide", spy)
    rp = matcher.predict(queries)
    compare_predictions(rj, rp)
    assert (0, cfg.model_depth_initial) in calls                       # wave B ran
    assert (cfg.model_depth_initial, 0) in calls                       # wave A
    assert (rp.stage == STAGE_MODEL).sum() > 0
    assert (rp.match_title_id == actual).mean() > 0.8


def test_predict_oracle_config_matches_jax(world4096):
    jcfg, jtruth, jq, cfg, truth, queries, actual = world4096
    rj = JMatcher(jcfg.with_(**ORACLE), truth=jtruth, model=JGBTModel.load(str(MODEL)),
                  use_index_checkpoint=False).predict(jq)
    matcher = Matcher(cfg.with_(**ORACLE), truth=truth, model=GBTModel.load(str(MODEL)), device="cpu")
    rp = matcher.predict(queries)
    compare_predictions(rj, rp)
    assert (rp.stage == STAGE_MODEL).sum() > 0
    assert (rp.match_title_id == actual).mean() > 0.8
