"""PyTorch port: a truth DB too small to fill ``top_n_predicting`` windows.

With window select (the default: tb = 2048, windows of 16 titles) a row's
top-100 keeps one candidate per window.  The windows run over the kernel's
permuted column order, so 301 titles fill 38 of them, and the other 62
candidates are padding positions (301 and up, score -1).  The
JAX package's device gathers clamp such a position, so it scores as a copy
of the last title, and its copies tie: a batch row whose best candidate is
one of them stays unmatched, a single title takes the first of them.
Where the reference reads a padding position with numpy (its host stages,
which decide a batch over one query block; a single title whose best
candidate is a copy) it raises ``IndexError``, and so must the port.

On the tree before the repair the port's fuzzy stage raised ``IndexError``
on every batch here (``t_len[pos]`` on the CPU, a device assert on the
card).  The reference runs the Pallas kernels in interpret mode with f32
scores, as the other parity tests do; stages and match ids must be equal,
probabilities agree to 1e-5 (``compare_predictions``).
"""

import random

import numpy as np
import pytest

import bench
from doppelspeller_tpu.models import trainer as jtrainer
from doppelspeller_tpu.ops.jaccard import JaccardScorer as JScorer
from doppelspeller_tpu.ops.ngram_index import build_truth_index as jbuild_truth_index
from doppelspeller_tpu.utils.io import TitleSet as JTitleSet
from doppelspeller_tpu_torch import synthetic
from doppelspeller_tpu_torch.models import trainer as ptrainer
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import compare_predictions
from test_torch_small_batch import BASE, _jax_matcher, _port_matcher, one_torch_thread  # noqa: F401

N_TITLES = 301


@pytest.fixture(scope="module")
def world301():
    jcfg, jtruth, jq, actual = bench.make_synthetic_world(N_TITLES, 300)
    jcfg = jcfg.with_(data_path="/tmp/doppel_tpu_test_data", top_n_predicting=100, **BASE)
    from test_torch_helpers import port_config

    cfg = port_config(jcfg)
    _, truth, queries, _ = synthetic.make_synthetic_world(N_TITLES, 300, config=cfg)
    return jcfg, jtruth, jq, cfg, truth, queries, actual


@pytest.fixture(scope="module")
def matchers(world301):
    jcfg, jtruth, _jq, cfg, truth, _queries, _actual = world301
    return _jax_matcher(jcfg, jtruth), _port_matcher(cfg, truth)


def test_candidates_hold_padding_positions(world301, matchers):
    _jcfg, _jtruth, _jq, cfg, _truth, queries, _actual = world301
    _jm, pm = matchers
    _, cand = pm.scorer.topk(queries, rows=np.arange(8))
    assert (cand >= N_TITLES).sum(axis=1).tolist() == [62] * 8


@pytest.mark.parametrize("n_queries,kw", [
    (120, {}),                           # 109 rows past exact: the one-dispatch path
    (150, {"cascade_impl": "device"}),   # the device cascade with waves A/B
])
def test_small_truth_batch_matches_jax(world301, matchers, monkeypatch, n_queries, kw):
    jcfg, _jtruth, jq, cfg, _truth, queries, actual = world301
    jm, pm = matchers
    monkeypatch.setattr(jm, "cfg", jcfg.with_(**kw))
    monkeypatch.setattr(pm, "cfg", cfg.with_(**kw))
    rows = list(range(n_queries))
    rj = jm.predict(JTitleSet.from_titles([jq.titles[i] for i in rows], config=jcfg))
    rp = pm.predict(TitleSet.from_titles([queries.titles[i] for i in rows], config=cfg))
    compare_predictions(rj, rp)
    assert all(rp.stage_counts[s] > 0 for s in ("exact", "fuzzy", "model"))
    assert (rp.match_title_id == actual[rows]).mean() > 0.9


@pytest.mark.parametrize("n_queries,kw", [(200, {}), (120, {"serve_fused": "off"})])
def test_small_truth_host_stages_raise_as_jax(world301, matchers, monkeypatch, n_queries, kw):
    """A batch over one query block, or with the one-dispatch path off:
    the reference's host stages index with numpy and raise."""
    jcfg, _jtruth, jq, cfg, _truth, queries, _actual = world301
    jm, pm = matchers
    monkeypatch.setattr(jm, "cfg", jcfg.with_(**kw))
    monkeypatch.setattr(pm, "cfg", cfg.with_(**kw))
    with pytest.raises(IndexError) as ej:
        jm.predict(JTitleSet.from_titles(jq.titles[:n_queries], config=jcfg))
    with pytest.raises(IndexError) as ep:
        pm.predict(TitleSet.from_titles(queries.titles[:n_queries], config=cfg))
    assert str(ep.value) == str(ej.value)
    assert "out of bounds for axis 0 with size 301" in str(ep.value)


def _misspelled_last_title(truth):
    from doppelspeller_tpu_torch.utils.misspell import generate_misspelled_name

    return generate_misspelled_name(truth.transformed[-1], random.Random(1))


@pytest.mark.parametrize("which", ["last_title_misspelled", "fuzzy", "model"])
def test_small_truth_single_titles_as_jax(world301, matchers, which):
    """A misspelling of the last title ties with its padding copies: fuzzy
    drops it, the model scores them all alike, and a single title takes the
    first maximum (the title itself, ranked before the padding), while in a
    batch the row stays unmatched.  Rows 45 and 25 match in fuzzy and in
    the model stage."""
    jcfg, _jtruth, jq, cfg, truth, queries, _actual = world301
    jm, pm = matchers
    if which == "last_title_misspelled":
        jt = pt = _misspelled_last_title(truth)
    else:
        i = {"fuzzy": 45, "model": 25}[which]
        jt, pt = jq.titles[i], queries.titles[i]
    sj = jm.predict(JTitleSet.from_titles([jt], config=jcfg), single=True)
    sp = pm.predict(TitleSet.from_titles([pt], config=cfg), single=True)
    compare_predictions(sj, sp)
    assert sp.stage[0] == (2 if which == "fuzzy" else 3)
    if which == "last_title_misspelled":
        assert sp.match_title_id[0] == truth.ids[-1]
        both = [pt, truth.titles[0]]
        bj = jm.predict(JTitleSet.from_titles(both, config=jcfg))
        bp = pm.predict(TitleSet.from_titles(both, config=cfg))
        compare_predictions(bj, bp)
        assert bp.match_title_id.tolist() == [-1, truth.ids[0]]


def test_small_truth_training_raises_as_jax(world301):
    """Training samples candidates by position, padding ones too, and the
    feature builder's host gathers raise in both packages."""
    jcfg, jtruth, jq, cfg, truth, queries, actual = world301
    labels = actual[:40]
    jtrain = JTitleSet.from_titles(jq.titles[:40], labels=labels, config=jcfg)
    ptrain = TitleSet.from_titles(queries.titles[:40], labels=labels, config=cfg)
    pj = jtrainer.assemble_training_pairs(jtrain, jtruth, JScorer(jbuild_truth_index(jtruth, jcfg), jcfg),
                                          jcfg, random.Random(jcfg.seed))
    pp = ptrainer.assemble_training_pairs(ptrain, truth, JaccardScorer(build_truth_index(truth, cfg), cfg,
                                                                       "cpu"), cfg, random.Random(cfg.seed))
    np.testing.assert_array_equal(pj.t_pos, pp.t_pos)
    assert (pp.t_pos >= N_TITLES).any()
    with pytest.raises(IndexError) as ej:
        jtrainer.build_feature_matrix(pj, jtrainer.WordCounts(jtruth), jtruth, jcfg)
    with pytest.raises(IndexError) as ep:
        ptrainer.build_feature_matrix(pp, ptrainer.WordCounts(truth), truth, cfg, "cpu")
    assert str(ep.value) == str(ej.value)
