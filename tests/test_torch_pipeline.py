"""PyTorch port, the slice end to end: ``Matcher.predict`` against the JAX
``Matcher.predict`` (device cascade, folded two-hash retrieval with the
Pallas kernel in interpret mode, f32 scoring) with the committed smoke model,
on the conftest ``world`` and on a 4096-title synthetic world deep enough
(top-100 candidates) for the model stage's waves A and B to engage."""

import numpy as np

import bench
from doppelspeller_tpu.models.gbt import GBTModel as JGBTModel
from doppelspeller_tpu.pipeline import Matcher as JMatcher
from doppelspeller_tpu_torch import synthetic
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.pipeline import STAGE_MODEL, Matcher
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import MODEL, compare_predictions, port_config

SLICE = dict(cascade_impl="device", retrieval_mode="folded", fold_hashes=2,
             retrieval_impl="pallas_interpret", score_dtype="float32")


def test_predict_matches_jax_on_world(world):
    jcfg, jtruth, _train, jtest, actual = world
    jcfg = jcfg.with_(**SLICE)
    rj = JMatcher(jcfg, truth=jtruth, model=JGBTModel.load(str(MODEL)),
                  use_index_checkpoint=False).predict(jtest)
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    test = TitleSet.from_titles(jtest.titles, ids=jtest.ids, config=cfg)
    rp = Matcher(cfg, truth=truth, model=GBTModel.load(str(MODEL)), device="cpu").predict(test)
    compare_predictions(rj, rp)
    assert all(rp.stage_counts[s] > 0 for s in ("exact", "fuzzy", "model"))
    assert (rp.match_title_id == actual).mean() > 0.8


def test_predict_matches_jax_with_waves(monkeypatch):
    jcfg, jtruth, jq, actual = bench.make_synthetic_world(4096, 512)
    jcfg = jcfg.with_(data_path="/tmp/doppel_tpu_test_data", top_n_predicting=100, **SLICE)
    rj = JMatcher(jcfg, truth=jtruth, model=JGBTModel.load(str(MODEL)),
                  use_index_checkpoint=False).predict(jq)
    cfg = port_config(jcfg)
    _, truth, queries, actual_p = synthetic.make_synthetic_world(4096, 512, config=cfg)
    np.testing.assert_array_equal(actual, actual_p)
    matcher = Matcher(cfg, truth=truth, model=GBTModel.load(str(MODEL)), device="cpu")
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
