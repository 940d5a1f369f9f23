"""PyTorch port: ``predict(single=True)``, tied candidates, and how
``cascade_impl`` resolves.

``predict(single=True)`` takes one query and, where fuzzy does not match it,
the first maximum of all its probabilities whatever its value and count, as
the JAX package's ``single_result()`` reports it.  The reference runs exact
union retrieval with the Pallas kernels in interpret mode and f32 scores.
Match ids and titles must be equal, probabilities agree to 1e-5.
"""

import numpy as np
import pytest

from doppelspeller_tpu.models.gbt import GBTModel as JGBTModel
from doppelspeller_tpu.pipeline import Matcher as JMatcher
from doppelspeller_tpu.utils.io import TitleSet as JTitleSet
from doppelspeller_tpu_torch import synthetic
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.pipeline import STAGE_EXACT, STAGE_FUZZY, STAGE_MODEL, STAGE_NONE, Matcher
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import MODEL, compare_predictions
from test_torch_small_batch import _jax_matcher, _port_matcher, one_torch_thread, world4096  # noqa: F401


@pytest.fixture(scope="module")
def matchers(world4096):
    jcfg, jtruth, _jq, cfg, truth, queries, _actual = world4096
    pm = _port_matcher(cfg, truth)
    return _jax_matcher(jcfg, jtruth), pm, pm.predict(queries)



@pytest.mark.parametrize("impl,n_rows,waves", [
    ("auto", 2048, True), ("auto", 2047, False), ("device", 3, True), ("host", 2100, False),
])
def test_cascade_impl_resolution(world4096, matchers, monkeypatch, impl, n_rows, waves):
    """``"auto"`` takes the waves from 2,048 rows past the exact stage on,
    ``"device"`` at any size, ``"host"`` never (the reference's rule)."""
    _jcfg, _jtruth, _jq, cfg, _truth, _queries, _actual = world4096
    _jm, pm, _batch = matchers
    _, _, many, _ = synthetic.make_synthetic_world(4096, 2600, seed=7, config=cfg)
    rem = [i for i, t in enumerate(many.transformed) if t not in pm.reverse]
    assert len(rem) >= 2100
    exact = next(i for i, t in enumerate(many.transformed) if t in pm.reverse)
    rows = [exact] + rem[:n_rows]                            # the exact hit does not count
    seen = []
    monkeypatch.setattr(pm, "cfg", cfg.with_(cascade_impl=impl))
    monkeypatch.setattr(pm, "_cascade_device",
                        lambda queries, rem, res, waves, single: seen.append((len(rem), waves, single)))
    pm.predict(TitleSet.from_titles([many.titles[i] for i in rows], config=cfg))
    assert seen == [(n_rows, waves, False)]


def _pick(res, stage):
    return int(np.flatnonzero(res.stage == stage)[0])


@pytest.mark.parametrize("kind", ["exact", "fuzzy", "model", "below_threshold"])
def test_single_title_matches_jax(world4096, matchers, kind):
    """``predict(single=True)`` against the reference's ``single_result()``:
    a title the exact stage matches, one fuzzy matches, one only the model
    matches, and one nobody matches in a batch, which in single mode still
    gets the first maximum of its probabilities, at or below the threshold."""
    jcfg, _jtruth, _jq, cfg, _truth, queries, _actual = world4096
    jm, pm, batch = matchers
    stage = {"exact": STAGE_EXACT, "fuzzy": STAGE_FUZZY, "model": STAGE_MODEL,
             "below_threshold": STAGE_NONE}[kind]
    title = queries.titles[_pick(batch, stage)]
    sj = jm.predict(JTitleSet.from_titles([title], config=jcfg), single=True).single_result()
    rp = pm.predict(TitleSet.from_titles([title], config=cfg), single=True)
    sp = rp.single_result()
    assert set(sp) == set(sj)
    for key in ("test_index", "transformed_title", "match_transformed_title", "match_title_id"):
        assert sp[key] == sj[key], key
    assert sp["prediction"] == pytest.approx(sj["prediction"], abs=1e-5)
    if kind == "below_threshold":
        assert rp.stage[0] == STAGE_MODEL and sp["match_title_id"] != cfg.train_not_found_value
        assert sp["prediction"] <= cfg.prediction_probability_threshold
    else:
        assert rp.stage[0] == stage


def test_single_needs_exactly_one_query(world4096, matchers):
    _jcfg, _jtruth, _jq, cfg, _truth, queries, _actual = world4096
    _jm, pm, _batch = matchers
    two = TitleSet.from_titles(queries.titles[:2], config=cfg)
    with pytest.raises(ValueError, match="exactly one query"):
        pm.predict(two, single=True)
    with pytest.raises(ValueError, match="exactly one query"):
        pm.predict(TitleSet.from_titles([], config=cfg), single=True)


def test_tied_candidates_small_batch_and_single(world4096):
    """A truth DB that holds one title twice (two ids): a misspelling of it
    ties both at the fuzzy maximum, so it drops to stage 3, where the two
    probabilities tie again.  A batch leaves the row unmatched; single mode
    takes the first of the tied maxima, as the reference's ``np.argmax``."""
    jcfg, jtruth, _jq, cfg, truth, _queries, _actual = world4096
    titles = list(truth.titles)
    dup = next(t for t in titles if len(t) > 16 and titles.count(t) == 1)
    titles.append(dup)
    ids = np.arange(1, len(titles) + 1)
    q = dup[:5] + dup[6:]                                   # one deletion: ratio > 94
    jm = JMatcher(jcfg, truth=JTitleSet.from_titles(titles, ids=ids, config=jcfg),
                  model=JGBTModel.load(str(MODEL)), use_index_checkpoint=False)
    pm = Matcher(cfg, truth=TitleSet.from_titles(titles, ids=ids, config=cfg),
                 model=GBTModel.load(str(MODEL)), device="cpu")
    for serve_fused in ("auto", "off"):
        jm.cfg = jcfg.with_(serve_fused=serve_fused)
        rj = jm.predict(JTitleSet.from_titles([q, titles[3]], config=jcfg))
        rp = pm.predict(TitleSet.from_titles([q, titles[3]], config=cfg))
        compare_predictions(rj, rp)
        assert rp.stage[0] == STAGE_NONE and rp.stage[1] == STAGE_EXACT
        sj = jm.predict(JTitleSet.from_titles([q], config=jcfg), single=True)
        sp = pm.predict(TitleSet.from_titles([q], config=cfg), single=True)
        compare_predictions(sj, sp)
        assert sp.stage[0] == STAGE_MODEL
        assert sp.match_title_id[0] in (ids[titles.index(dup)], ids[-1])
