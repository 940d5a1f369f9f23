"""PyTorch port: ``Matcher.predict`` on small batches.

Under the default ``cascade_impl="auto"`` a batch with fewer than 2,048 rows
past the exact stage scores every one of its ``top_n_predicting``
candidates (no waves A/B, no trust band), as the JAX package's fused and
host paths do (single titles: ``tests/test_torch_single_title.py``).  The
reference runs exact union retrieval with the Pallas kernels in
interpret mode and f32 scores, as the other parity tests do.  Stages and
match ids must be equal, probabilities agree to 1e-5
(``compare_predictions``).
"""

import numpy as np
import pytest
import torch

import bench
from doppelspeller_tpu.models.gbt import GBTModel as JGBTModel
from doppelspeller_tpu.pipeline import Matcher as JMatcher
from doppelspeller_tpu_torch import synthetic
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.pipeline import Matcher
from test_torch_helpers import MODEL, compare_predictions, port_config

BASE = dict(retrieval_mode="auto", retrieval_impl="pallas_interpret", score_dtype="float32")
# with these the waves decide on the first 4 candidates alone (no row
# widens), so on this world the reference's own "device" and "host" results
# differ: a test under them can tell which path the port took
SHIFTED = dict(model_widen_threshold=2.0, model_trust_threshold=2.0, model_depth_initial=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path here is thousands of small tensor operations; with
    several test workers on one machine their intra-op thread pools only
    contend, so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world4096():
    jcfg, jtruth, jq, actual = bench.make_synthetic_world(4096, 512)
    jcfg = jcfg.with_(data_path="/tmp/doppel_tpu_test_data", top_n_predicting=100, **BASE)
    cfg = port_config(jcfg)
    _, truth, queries, _ = synthetic.make_synthetic_world(4096, 512, config=cfg)
    return jcfg, jtruth, jq, cfg, truth, queries, actual


def _jax_matcher(jcfg, jtruth, **kw):
    return JMatcher(jcfg.with_(**kw), truth=jtruth, model=JGBTModel.load(str(MODEL)),
                    use_index_checkpoint=False)


def _port_matcher(cfg, truth, **kw):
    return Matcher(cfg.with_(**kw), truth=truth, model=GBTModel.load(str(MODEL)), device="cpu")


def _spy_decide(matcher, monkeypatch):
    calls = []
    decide = matcher.rerank.decide

    def spy(*args, **kwargs):
        calls.append((kwargs.get("narrow", 0), kwargs.get("col_lo", 0)))
        return decide(*args, **kwargs)

    monkeypatch.setattr(matcher.rerank, "decide", spy)
    return calls


@pytest.mark.parametrize("serve_fused", ["auto", "off"])
def test_small_batch_default_cascade_matches_jax(world4096, monkeypatch, serve_fused):
    """512 queries under the default ``cascade_impl``: the reference takes
    its fused one-dispatch path (``"auto"``) or its host stages (``"off"``);
    the port scores every candidate in one wave."""
    jcfg, jtruth, jq, cfg, truth, queries, actual = world4096
    rj = _jax_matcher(jcfg, jtruth, serve_fused=serve_fused).predict(jq)
    matcher = _port_matcher(cfg, truth, serve_fused=serve_fused)
    calls = _spy_decide(matcher, monkeypatch)
    rp = matcher.predict(queries)
    compare_predictions(rj, rp)
    assert calls and set(calls) == {(0, 0)}                 # full depth, one wave
    assert all(rp.stage_counts[s] > 0 for s in ("exact", "fuzzy", "model"))
    assert (rp.match_title_id == actual).mean() > 0.8


def test_small_batch_paths_told_apart_by_shifted_thresholds(world4096, monkeypatch):
    jcfg, jtruth, jq, cfg, truth, queries, _actual = world4096
    rj_device = _jax_matcher(jcfg, jtruth, cascade_impl="device", **SHIFTED).predict(jq)
    rj_auto = _jax_matcher(jcfg, jtruth, serve_fused="off", **SHIFTED).predict(jq)
    differ = int((rj_device.match_title_id != rj_auto.match_title_id).sum())
    assert differ > 0, "the reference's own device and host results must differ here"
    # default cascade_impl: the port equals the reference's small-batch result
    rp_auto = _port_matcher(cfg, truth, **SHIFTED).predict(queries)
    compare_predictions(rj_auto, rp_auto)
    # "device" takes the waves at this size too
    matcher = _port_matcher(cfg, truth, cascade_impl="device", **SHIFTED)
    calls = _spy_decide(matcher, monkeypatch)
    rp_device = matcher.predict(queries)
    compare_predictions(rj_device, rp_device)
    assert set(calls) == {(SHIFTED["model_depth_initial"], 0)}          # wave A alone
