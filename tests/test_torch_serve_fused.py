"""PyTorch port: the one-dispatch small-batch path (``ops/serve_fused.py``),
the host stages it hands rows to, and ``fuzzy_tile_cap``.

A batch of at most one query block takes the fused path in both packages.
The reference runs the Pallas kernels in interpret mode with f32 scores, as
the other parity tests do; the matchers here take 8-query blocks (the serve
loop's latency profile), which keeps the CPU runs short.  Stages and match
ids must be equal, probabilities agree to 1e-5 (``compare_predictions``).
"""

import logging
import os

import numpy as np
import pytest
import torch

from doppelspeller_tpu.models.gbt import GBTModel as JGBTModel
from doppelspeller_tpu.pipeline import Matcher as JMatcher
from doppelspeller_tpu.utils.io import TitleSet as JTitleSet
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.ops.fuzzy import fuzzy_decide
from doppelspeller_tpu_torch.pipeline import STAGE_EXACT, STAGE_FUZZY, STAGE_MODEL, STAGE_NONE, Matcher
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import MODEL, compare_predictions, untied
from test_torch_small_batch import _jax_matcher, _port_matcher, one_torch_thread, world4096  # noqa: F401
from test_torch_small_truth import world301  # noqa: F401

QB8 = dict(query_block=8)
LONG_TITLE = "aaxq bbxq ccxq ddxq eexq ffxq ggxq hhxq iixq jjxq kkxq"


def _no_cascade(*args, **kwargs):
    raise AssertionError("the batch cascade ran where the one-dispatch path should")


@pytest.fixture(scope="module")
def fused(world4096):
    """(JAX matcher, port matcher, port matcher with the path off, the
    first 64 queries as the port's ``"off"`` path decides them)."""
    jcfg, jtruth, _jq, cfg, truth, queries, _actual = world4096
    pm = _port_matcher(cfg, truth, **QB8)
    off = _port_matcher(cfg, truth, serve_fused="off", **QB8)
    first = TitleSet.from_titles(queries.titles[:64], ids=queries.ids[:64], config=cfg)
    return _jax_matcher(jcfg, jtruth, **QB8), pm, off, off.predict(first)


@pytest.mark.parametrize("kind", ["exact", "fuzzy", "model", "below_threshold", "batch8"])
def test_fused_matches_jax_and_off(world4096, fused, monkeypatch, kind):
    """Four single titles (one of each stage, and one no stage matches in a
    batch, which a single title still answers) and a batch of 8: the port's
    fused path against the reference's ``FusedServe`` and the port's
    ``serve_fused="off"``."""
    jcfg, _jtruth, _jq, cfg, _truth, queries, _actual = world4096
    jm, pm, off, first = fused
    monkeypatch.setattr(pm, "_cascade_device", _no_cascade)
    if kind == "batch8":
        titles, single = queries.titles[:8], False
    else:
        stage = {"exact": STAGE_EXACT, "fuzzy": STAGE_FUZZY, "model": STAGE_MODEL,
                 "below_threshold": STAGE_NONE}[kind]
        titles, single = [queries.titles[int(np.flatnonzero(first.stage == stage)[0])]], True
    ids = np.arange(len(titles), dtype=np.int64)
    rj = jm.predict(JTitleSet.from_titles(titles, ids=ids, config=jcfg.with_(**QB8)), single=single)
    qs = TitleSet.from_titles(titles, ids=ids, config=cfg)
    rp = pm.predict(qs, single=single)
    compare_predictions(rj, rp)
    assert rp.match_transformed == rj.match_transformed
    compare_predictions(off.predict(qs, single=single), rp)
    assert rp.stage_seconds["fuzzy"] == rp.stage_seconds["model"] == 0.0
    if kind == "batch8":
        assert len(set(rp.stage.tolist())) >= 3
    elif kind == "below_threshold":
        assert rp.stage[0] == STAGE_MODEL and rp.prediction[0] <= cfg.prediction_probability_threshold


@pytest.mark.parametrize("single", [False, True])
def test_fused_folded_matches_jax(world4096, monkeypatch, single):
    """The folded branch (folded two-hash retrieval, 8-query blocks): a
    batch of 6 and a single title against the reference's and against the
    port's ``"off"`` path.  Window select stays on, as the port's folded
    engine always selects per window."""
    jcfg, jtruth, _jq, cfg, truth, queries, _actual = world4096
    kw = dict(retrieval_mode="folded", **QB8)
    jm = _jax_matcher(jcfg, jtruth, **kw)
    pm = _port_matcher(cfg, truth, **kw)
    assert pm.scorer.folded is not None and jm.scorer.folded is not None
    monkeypatch.setattr(pm, "_cascade_device", _no_cascade)
    titles = queries.titles[40:41] if single else queries.titles[10:16]
    ids = np.arange(len(titles), dtype=np.int64)
    rj = jm.predict(JTitleSet.from_titles(titles, ids=ids, config=jm.cfg), single=single)
    qs = TitleSet.from_titles(titles, ids=ids, config=pm.cfg)
    rp = pm.predict(qs, single=single)
    compare_predictions(rj, rp)
    assert pm._fused_engine().mode == "folded"
    compare_predictions(_port_matcher(cfg, truth, serve_fused="off", **kw).predict(qs, single=single), rp)


def _with_long_title(jtruth, truth, jcfg, cfg):
    ids = np.append(truth.ids, [9009])
    return (JTitleSet.from_titles(list(jtruth.titles) + [LONG_TITLE], ids=ids, config=jcfg),
            TitleSet.from_titles(list(truth.titles) + [LONG_TITLE], ids=ids, config=cfg))


def _long_title_matchers(jcfg, jtruth, cfg, truth):
    jtruth2, truth2 = _with_long_title(jtruth, truth, jcfg, cfg)
    jm = JMatcher(jcfg, truth=jtruth2, model=JGBTModel.load(str(MODEL)), use_index_checkpoint=False)
    pm = Matcher(cfg, truth=truth2, model=GBTModel.load(str(MODEL)), device="cpu")
    # the candidates probe at 54 characters, past a forced bucket of 32
    jm._fused_engine().tlr_default = 32
    pm._fused_engine().tlr_default = 32
    return jm, pm, truth2


def _records(caplog, text):
    return [r for r in caplog.records if text in r.getMessage()]


def test_fused_bucket_fallback_matches_jax(world4096, caplog):
    """A row whose candidates exceed the static model bucket is decided
    again by the host stages on its candidates, in both packages: a short
    query retrieves a 54-character truth title past a forced 32 bucket."""
    jcfg, jtruth, jq, cfg, truth, queries, _actual = world4096
    jm, pm, truth2 = _long_title_matchers(jcfg.with_(**QB8), jtruth, cfg.with_(**QB8), truth)
    # queries of at most 32 characters keep the model tile at the bucket
    titles = ["aaxq bbxq ccxq"] + [t for t in queries.titles if len(t) <= 30][:5]
    ids = np.arange(len(titles), dtype=np.int64)
    with caplog.at_level(logging.INFO):
        rj = jm.predict(JTitleSet.from_titles(titles, ids=ids, config=jm.cfg))
        rp = pm.predict(TitleSet.from_titles(titles, ids=ids, config=pm.cfg))
    assert len(_records(caplog, "classic host redo")) == 2, "the fallback did not fire in both"
    jrec, prec = (next(r for r in _records(caplog, "classic host redo") if r.name.startswith(p))
                  for p in ("doppelspeller_tpu.", "doppelspeller_tpu_torch."))
    assert jrec.getMessage() == prec.getMessage()
    compare_predictions(rj, rp)
    off = Matcher(pm.cfg.with_(serve_fused="off"), truth=truth2, model=GBTModel.load(str(MODEL)),
                  device="cpu")
    compare_predictions(off.predict(TitleSet.from_titles(titles, ids=ids, config=pm.cfg)), rp)


def test_fused_bucket_fallback_raises_on_padding_as_jax(world301, caplog):
    """On a truth DB too small to fill k windows every row holds padding
    candidates; a row past the model bucket goes to the host stages, which
    index the truth arrays with numpy: both packages raise the same
    ``IndexError``."""
    jcfg, jtruth, jq, cfg, truth, queries, _actual = world301
    jm, pm, _ = _long_title_matchers(jcfg, jtruth, cfg, truth)
    titles = ["aaxq bbxq ccxq"] + [t for t in queries.titles if len(t) <= 30][:5]
    with pytest.raises(IndexError) as ej:
        jm.predict(JTitleSet.from_titles(titles, config=jcfg))
    with caplog.at_level(logging.INFO), pytest.raises(IndexError) as ep:
        pm.predict(TitleSet.from_titles(titles, config=cfg))
    assert _records(caplog, "classic host redo")
    assert str(ep.value) == str(ej.value)
    assert "out of bounds for axis 0 with size 302" in str(ep.value)


@pytest.fixture(scope="module")
def capped(world4096, tmp_path_factory):
    """``cascade_impl="device"`` with ``fuzzy_tile_cap=32`` on 48 queries,
    each package writing its ``DOPPEL_DUMP_WAVES`` file; and the port
    uncapped.  Returns (JAX result, port result, port uncapped, the two
    dumps, the warnings logged)."""
    jcfg, jtruth, jq, cfg, truth, queries, _actual = world4096
    kw = dict(cascade_impl="device", fuzzy_tile_cap=32)
    rows = np.arange(48)
    jb = JTitleSet.from_titles([jq.titles[i] for i in rows], ids=jq.ids[rows], config=jcfg)
    pb = TitleSet.from_titles([queries.titles[i] for i in rows], ids=queries.ids[rows], config=cfg)
    dumps = [str(tmp_path_factory.mktemp("waves") / f"{n}.npz") for n in ("jax", "port")]
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record)

    keep = Keep(logging.INFO)
    root = logging.getLogger()
    level = root.level
    root.addHandler(keep)
    root.setLevel(logging.INFO)
    try:
        os.environ["DOPPEL_DUMP_WAVES"] = dumps[0]
        rj = _jax_matcher(jcfg, jtruth, **kw).predict(jb)
        os.environ["DOPPEL_DUMP_WAVES"] = dumps[1]
        rp = _port_matcher(cfg, truth, **kw).predict(pb)
    finally:
        os.environ.pop("DOPPEL_DUMP_WAVES", None)
        root.removeHandler(keep)
        root.setLevel(level)
    uncapped = _port_matcher(cfg, truth, cascade_impl="device").predict(pb)
    return rj, rp, uncapped, [dict(np.load(d)) for d in dumps], seen


def test_fuzzy_tile_cap_matches_jax_and_uncapped(capped):
    """Rows with a considered pair longer than the capped 32-character tile
    are flagged on the device and decided again by the host fuzzy stage,
    in both packages, with the reference's warning; the results equal the
    reference's and the uncapped port's."""
    rj, rp, uncapped, _dumps, seen = capped
    compare_predictions(rj, rp)
    compare_predictions(uncapped, rp)
    redo = [r.getMessage() for r in seen if "host redo" in r.getMessage()]
    assert len(redo) == 2 and redo[0] == redo[1], redo
    assert int(redo[0].split()[4]) > 0


def test_dump_waves_matches_jax(capped):
    """``DOPPEL_DUMP_WAVES``: both waves' per-row stats of every widened row,
    under the reference's keys.  Rows are compared as a set (the reference
    orders them by its retrieval groups, the port by rows): positions
    exactly, probabilities to 1e-5, and the count at the max of the wave
    that decides the row exactly (the losing wave's max can be a tie of
    candidates whose probabilities differ in the last bit between the
    packages); the three wave-B lines are logged in the reference's
    wording."""
    _rj, _rp, _uncapped, (dj, dp), seen = capped
    assert set(dj) == set(dp) == {"widen", "mx_a", "mx_b", "pos_a", "pos_b", "cnt_a", "cnt_b"}
    assert len(dp["widen"]) == len(dj["widen"]) > 0

    def rows(d):
        order = np.lexsort((d["mx_a"], d["pos_b"], d["pos_a"]))
        a_wins = d["mx_a"] >= d["mx_b"]
        return (np.stack([d["pos_a"], d["pos_b"], np.where(a_wins, d["cnt_a"], d["cnt_b"])], axis=1)[order],
                np.stack([d["mx_a"], d["mx_b"]], axis=1)[order])

    (ij, fj), (ip, fp) = rows(dj), rows(dp)
    np.testing.assert_array_equal(ij, ip)
    np.testing.assert_allclose(fj, fp, atol=1e-5)
    for start in ("model wave B: %d/%d rows widened", "model wave B: %d slabs dispatched",
                  "model wave B: tail won"):
        names = {r.name.split(".")[0] for r in seen if r.msg.startswith(start)}
        assert names == {"doppelspeller_tpu", "doppelspeller_tpu_torch"}, start


def test_topk_title_ids_matches_jax(world4096, fused):
    jcfg, _jtruth, jq, cfg, _truth, queries, _actual = world4096
    jm, pm, _off, _first = fused
    rows = np.array([5, 1, 77, 300, 12])
    vj, tj = jm.scorer.topk_title_ids(jq, k=20, rows=rows)
    vp, tp = pm.scorer.topk_title_ids(queries, k=20, rows=rows)
    np.testing.assert_allclose(vj, vp, rtol=1e-5, atol=1e-6)
    mask = untied(vj)
    assert mask.sum() > 20
    np.testing.assert_array_equal(tj[mask], tp[mask])
    assert np.isin(tp, pm.index.title_ids).all()


def _pairs(truth, queries, actual, seed, n=400):
    """24 query rows and n random (row, truth position) pairs among them,
    then each row's own truth title where it has one."""
    rng = np.random.default_rng(seed)
    rem = rng.choice(len(queries), 24, replace=False)
    hit = np.flatnonzero(actual[rem] >= 0)
    pos_of = {int(t): i for i, t in enumerate(truth.ids)}
    pair_q = np.concatenate([rng.integers(0, len(rem), n), hit])
    pair_t = np.concatenate([rng.integers(0, len(truth), n), [pos_of[int(t)] for t in actual[rem][hit]]])
    return rem, pair_q, pair_t


def test_fuzzy_ratios_match_jax(world4096, fused):
    """``FuzzyEngine.ratios`` (the host fuzzy stage's pairs) equals the
    reference's on the same pairs, among them each query's own truth title."""
    jcfg, _jtruth, jq, cfg, truth, queries, actual = world4096
    jm, pm, _off, _first = fused
    rem, pair_q, pair_t = _pairs(truth, queries, actual, 1)
    args = []
    for m, q in ((jm, jq), (pm, queries)):
        ts_enc, ts_len = q.encoded_token_sorted
        args.append((q.encoded[rem], q.lengths[rem].astype(np.int32), ts_enc[rem],
                     ts_len[rem], pair_q, pair_t, truth.lengths))
    rj = jm._fuzzy_engine().ratios(*args[0], jm.ts_truth[1])
    rp = pm.fuzzy.ratios(*args[1], pm.ts_truth[1])
    np.testing.assert_array_equal(rj, rp)
    assert (rp > cfg.levenshtein_ratio_threshold).sum() > 0 and len(np.unique(rp)) > 20


def test_rerank_score_matches_jax(world4096, fused):
    """``RerankEngine.score`` (the host model stage's pairs) equals the
    reference's on the same pairs to 1e-5."""
    from doppelspeller_tpu_torch.ops.features import remove_spaces_host

    jcfg, _jtruth, jq, cfg, truth, queries, actual = world4096
    jm, pm, _off, _first = fused
    rem, pair_q, pair_t = _pairs(truth, queries, actual, 2)
    out = []
    for engine, q in ((jm._rerank_engine(), jq), (pm.rerank, queries)):
        q_wo, q_wo_len = remove_spaces_host(q.encoded[rem], q.lengths[rem])
        out.append(engine.score(q.encoded[rem], q.lengths[rem].astype(np.int32), q_wo, q_wo_len,
                                pair_q, pair_t, truth.lengths))
    np.testing.assert_allclose(out[0], out[1], atol=1e-5)
    assert out[1].min() < 0.1 and out[1].max() > 0.5


@pytest.mark.parametrize("tl", [32, 64])
def test_fuzzy_decide_static_equals_compacting(tl):
    """``static=True`` scores both ratios of every pair; its decisions are
    exactly those of the compacting default on random rows (long and short
    titles, candidates that pass the prefilter and ones that do not)."""
    g = torch.Generator().manual_seed(tl)
    R, K, n = 48, 24, 300
    t_len = torch.randint(1, tl + 8, (n,), generator=g)
    t_enc = torch.randint(2, 6, (n, 255), generator=g, dtype=torch.uint8)
    t_enc[torch.arange(255)[None, :] >= t_len[:, None]] = 0
    t_ts = t_enc.flip(1)
    t_ts_len = t_len.clone()
    cand = torch.randint(0, n, (R, K), generator=g, dtype=torch.int32)
    # each query a copy of one of its candidates with a character changed
    src = cand[:, 0].to(torch.int64)
    q_enc = t_enc[src].clone()
    q_enc[:, 0] = 5
    q_len = t_len[src].clone()
    args = (q_enc, q_len, q_enc.flip(1), q_len, t_enc, t_len, t_ts, t_ts_len,
            torch.randint(1, 12, (n,), generator=g), cand)
    a = fuzzy_decide(*args, tl=tl, threshold=94)
    b = fuzzy_decide(*args, tl=tl, threshold=94, static=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[0].any() and not a[0].all()
