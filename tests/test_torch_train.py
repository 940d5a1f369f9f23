"""PyTorch port, the training path against the JAX package on the CPU.

The same inputs, made from a seed with numpy, go through each JAX function
and its counterpart in the port (``device="cpu"``).  Tolerances:

- host numpy pieces (bin edges, bins, custom error, AUC, evaluation split,
  training pairs): **equal**;
- ``margin_grad_hess``: 1e-6;
- ``build_tree`` on inputs whose f32 sums are exact (``g`` in multiples of
  1/8 or 1/256, ``h`` = 1): structure **equal**, ``value`` and ``contrib``
  to 1e-6;
- ``train_gbt``: structure equal (``split_bin``, ``missing_left`` and
  ``threshold`` at the nodes that split: at a leaf they are the argmax over
  gains none of which is a valid positive gain, rounding noise that nothing
  reads) but for splits tied in exact arithmetic, which the ten-round case
  counts (see ``_assert_same_model``), values to 1e-5,
  error histories within one row's weight (``beta`` = 5: ``jax.nn.sigmoid``
  and ``torch.sigmoid`` differ in the last bit, and the custom error counts
  rows across a threshold);
- features: as ``tests/test_torch_features.py``, atol 1e-5 with NaNs in the
  same places.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doppelspeller_tpu.models import gbt as jgbt
from doppelspeller_tpu.models import trainer as jtrainer
from doppelspeller_tpu.ops import features as jfeatures
from doppelspeller_tpu.ops.jaccard import JaccardScorer as JScorer
from doppelspeller_tpu.ops.ngram_index import build_truth_index as jbuild_truth_index
from doppelspeller_tpu.pipeline import Matcher as JMatcher
from doppelspeller_tpu_torch import constants, synthetic
from doppelspeller_tpu_torch.models import gbt as pgbt
from doppelspeller_tpu_torch.models import trainer as ptrainer
from doppelspeller_tpu_torch.ops import features as pfeatures
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
from doppelspeller_tpu_torch.pipeline import Matcher
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import compare_predictions, port_config

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path here is thousands of small tensor operations; with
    several test workers on one machine their intra-op thread pools only
    contend, so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- host pieces

def _matrix(n=700, f=5, seed=0, nan=0.15):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, f) * 3.0, 1).astype(np.float32)      # rounded: repeated values
    X[rng.rand(n, f) < nan] = np.nan
    X[:, f - 1] = np.nan                                           # an all-missing feature
    return X


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_edges_and_bins_equal(seed):
    X = _matrix(seed=seed)
    ej, ep = jgbt.compute_bin_edges(X), pgbt.compute_bin_edges(X)
    np.testing.assert_array_equal(ej, ep)
    Xo = _matrix(n=300, seed=seed + 10)                            # other rows, same edges
    bj, bp = jgbt.bin_features(Xo, ej), pgbt.bin_features(Xo, ep)
    np.testing.assert_array_equal(bj, bp)
    assert (bp[np.isnan(Xo)] == pgbt.MISSING_BIN).all() and bp.dtype == np.uint8
    assert (pgbt.NB, pgbt.MISSING_BIN, pgbt.N_EDGES) == (jgbt.NB, jgbt.MISSING_BIN, jgbt.N_EDGES)


def test_custom_error_and_auc_equal_with_ties():
    rng = np.random.RandomState(2)
    pred = np.round(rng.rand(500), 2).astype(np.float32)           # many tied predictions
    pred[:20] = 0.9                                                # on the threshold: not positive
    y = (rng.rand(500) < 0.4).astype(np.float32)
    assert pgbt.custom_error(pred, y, 5.0, 0.9) == jgbt.custom_error(pred, y, 5.0, 0.9)
    assert pgbt.auc_score(pred, y) == jgbt.auc_score(pred, y)
    assert pgbt.auc_score(pred, np.ones_like(y)) == jgbt.auc_score(pred, np.ones_like(y)) == 0.5
    assert ptrainer.error_matrix(pred, y, 0.9) == jtrainer.error_matrix(pred, y, 0.9)


def test_params_from_config_equal(world):
    jcfg = world[0]
    pj, pp = jgbt.GBTParams.from_config(jcfg), pgbt.GBTParams.from_config(port_config(jcfg))
    assert vars(pj) == vars(pp)
    assert (constants.TRAINING_KIND_GENERATED, constants.TRAINING_KIND_NEGATIVE,
            constants.TRAINING_KIND_POSITIVE) == (1, 2, 3)


@pytest.mark.parametrize("seed", [None, 3])
def test_evaluation_indexes_equal(world, seed):
    jcfg = world[0]
    kind = np.random.RandomState(4).choice([1, 2, 3], size=900, p=[0.7, 0.1, 0.2]).astype(np.uint8)
    ij = jtrainer.evaluation_indexes(kind, jcfg, seed=seed)
    ip = ptrainer.evaluation_indexes(kind, port_config(jcfg), seed=seed)
    np.testing.assert_array_equal(ij, ip)
    assert len(ip) > 0
    # a kind smaller than its share of the total is taken whole (clipped)
    few = np.array([1] * 95 + [2] * 5, np.uint8)
    np.testing.assert_array_equal(jtrainer.evaluation_indexes(few, jcfg),
                                  ptrainer.evaluation_indexes(few, port_config(jcfg)))


def test_margin_grad_hess_matches_jax():
    rng = np.random.RandomState(5)
    m = (rng.randn(4000) * 4.0).astype(np.float32)
    y = (rng.rand(4000) < 0.5).astype(np.float32)
    gj, hj = jgbt.margin_grad_hess(jnp.asarray(m), jnp.asarray(y), 5.0)
    gp, hp = pgbt.margin_grad_hess(torch.from_numpy(m), torch.from_numpy(y), 5.0)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=1e-6, rtol=0)


# ------------------------------------------------------------- tree growth

def _tree_inputs(seed, n=1500, f=6, missing=False, unit=8):
    """Bins, and g in multiples of 1/``unit`` with h = 1: every f32 sum over
    them is exact in any order."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    if missing:
        X[rng.rand(n, f) < 0.2] = np.nan
    bins = pgbt.bin_features(X, pgbt.compute_bin_edges(X))
    signal = np.where(np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 2]) > 0, 2.0, -2.0)
    g = (np.round((signal + rng.randn(n)) * unit) / unit).astype(np.float32)
    h = np.ones(n, np.float32)
    return bins, g, h


def _both_trees(bins, g, h, depth, lambda_=1.0, mcw=1.0):
    oj = jgbt.build_tree_kernel(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), depth=depth, n_features=bins.shape[1],
        lambda_=lambda_, min_child_weight=mcw, return_routing=True, hist_impl="scatter")
    op = pgbt.build_tree(torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(h),
                         depth=depth, lambda_=lambda_, min_child_weight=mcw)
    return [np.asarray(a) for a in oj], [a.numpy() for a in op]


def _assert_same_tree(oj, op):
    for name, a, b in zip(("feat", "split_bin", "missing_left"), oj[:3], op[:3]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(oj[4], op[4], err_msg="is_leaf")
    np.testing.assert_allclose(op[3], oj[3], atol=1e-6, rtol=0, err_msg="value")
    np.testing.assert_allclose(op[5], oj[5], atol=1e-6, rtol=0, err_msg="contrib")
    assert op[0].dtype == np.int32 and op[1].dtype == np.int32 and op[2].dtype == bool


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("depth", [2, 5])
def test_build_tree_matches_jax_on_exact_sums(depth, missing):
    bins, g, h = _tree_inputs(seed=depth, missing=missing)
    oj, op = _both_trees(bins, g, h, depth)
    _assert_same_tree(oj, op)
    assert (op[0][: 2 ** depth - 1] >= 0).sum() >= 2 ** depth // 2       # it really split
    if missing:
        assert op[2].any() and (bins == pgbt.MISSING_BIN).any()


def test_build_tree_last_level_rounds_to_bf16():
    """g in multiples of 1/256 near ±2: exact in every f32 sum, but not in
    bf16, and the reference's last-level leaf sums take bf16 values."""
    bins, g, h = _tree_inputs(seed=7, unit=256)
    g_b = torch.from_numpy(g).to(torch.bfloat16).to(torch.float32).numpy()
    assert (g_b != g).mean() > 0.5
    oj, op = _both_trees(bins, g, h, 3)
    _assert_same_tree(oj, op)
    # without the rounding the last level's values would be off by far more
    last = slice(2 ** 3 - 1, 2 ** 4 - 1)
    node = np.zeros(len(g), np.int64)
    for _ in range(3):
        f, k, ml = op[0][node], op[1][node], op[2][node]
        b = bins[np.arange(len(g)), np.maximum(f, 0)]
        left = np.where(b == pgbt.MISSING_BIN, ml, b <= k)
        node = np.where(op[4][node], node, 2 * node + 2 - left)
    unrounded = np.array([-g[node == i].sum() / ((node == i).sum() + 1.0)
                          for i in range(last.start, last.stop)], np.float32)
    assert np.abs(unrounded - op[3][last]).max() > 1e-4


def test_build_tree_routes_rows_of_weight_zero():
    """Rows with g = h = 0 (the eval rows of the boosting loop) add to no
    sum and are still routed to a leaf."""
    bins, g, h = _tree_inputs(seed=9, missing=True)
    w = (np.arange(len(g)) % 3 != 0).astype(np.float32)
    oj, op = _both_trees(bins, g * w, h * w, 4)
    _assert_same_tree(oj, op)
    # the tree is the one grown on the weighted rows alone
    keep = w > 0
    _, alone = _both_trees(bins[keep], g[keep], h[keep], 4)
    for a, b in zip(op[:5], alone[:5]):
        np.testing.assert_array_equal(a, b)
    assert np.abs(op[5][~keep]).min() > 0                     # every unweighted row got a leaf


def test_build_tree_leaves_early_and_keeps_min_child_weight():
    bins, g, h = _tree_inputs(seed=11, n=60)
    oj, op = _both_trees(bins, g, h, 5, mcw=8.0)
    _assert_same_tree(oj, op)
    assert op[4][: 2 ** 5 - 1].any()                          # leaves above the last level


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_tree_ignores_the_order_of_rows(seed):
    """The histograms add in fixed point, so the same rows in another order
    give the same sums bit for bit, hence the same tree, as the card's
    atomics need.  f32 ``index_add_`` of the same values (the histograms
    before fixed point) rounds in the order of the rows and differs."""
    rng = np.random.RandomState(seed)
    n, f = 3000, 6
    X = rng.randn(n, f).astype(np.float32)
    X[rng.rand(n, f) < 0.1] = np.nan
    bins = pgbt.bin_features(X, pgbt.compute_bin_edges(X))
    g = (rng.randn(n) + np.where(np.nan_to_num(X[:, 0]) > 0, 1.0, -1.0)).astype(np.float32)
    h = rng.rand(n).astype(np.float32)
    perm = rng.permutation(n)
    kw = dict(depth=5, lambda_=1.0, min_child_weight=1.0)
    a = pgbt.build_tree(*map(torch.from_numpy, (bins, g, h)), **kw)
    b = pgbt.build_tree(*map(torch.from_numpy, (bins[perm], g[perm], h[perm])), **kw)
    for name, x, y in zip(("feat", "split_bin", "missing_left", "value", "is_leaf"), a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)
    np.testing.assert_array_equal(a[5].numpy()[perm], b[5].numpy())
    assert (a[0].numpy() >= 0).sum() >= 16                            # it really split

    def level0(rows):
        key = torch.from_numpy((bins[rows].astype(np.int64) + np.arange(f) * pgbt.NB).reshape(-1))
        v = torch.from_numpy(np.repeat(g[rows], f))
        (q,), unit = pgbt._quantize([v], n * f)
        fixed = pgbt._segment_sum([key], [q], unit, f * pgbt.NB)
        return fixed, torch.zeros(f * pgbt.NB).index_add_(0, key, v)

    (fa, f32a), (fb, f32b) = level0(np.arange(n)), level0(perm)
    assert torch.equal(fa, fb)
    assert not torch.equal(f32a, f32b)
    np.testing.assert_allclose(fa.numpy(), f32a.numpy(), atol=1e-5, rtol=1e-5)


def test_fixed_point_shift_and_its_limit():
    def shift(v, n):
        return int(pgbt.fixed_point_shift(torch.tensor(v), n))

    assert shift(1.0, 1) == 61                                         # 2^0 · 2^61 < 2^62
    assert shift(0.75, 4) == 60                                        # 3 · 2^60 < 2^62
    assert shift(5.0, 4_383_984) == 37                                 # the smoke's level keys
    assert shift(0.0, 10) == 62 and shift(1e-30, 10) == 100
    X, y = _gbt_data(40, 0)
    with pytest.raises(ValueError, match="fractional bits"):
        pgbt.train_gbt(X, y, X, y, pgbt.GBTParams(num_boost_round=1, beta=2.0 ** 40),
                       verbose_every=0, device="cpu")


# ---------------------------------------------------------------- boosting

def _gbt_data(n, seed):
    """The shape of the JAX package's own GBT tests, 8 features, with
    informative missing values."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8).astype(np.float32)
    logits = 2.0 * X[:, 0] - 1.5 * X[:, 2] + 0.5 * X[:, 4]
    y = (logits + 0.3 * rng.randn(n) > 0).astype(np.float32)
    X[(rng.rand(n) < 0.3) & (y == 1), 1] = np.nan
    return X, y


def _tied_splits(mj, mp):
    """bool[T, n_heap]: nodes where the two models hold another split, and
    bool[T, n_heap]: nodes below such a node."""
    splits = (mj.feat >= 0) | (mp.feat >= 0)
    differ = (mj.feat != mp.feat) | (mj.is_leaf != mp.is_leaf) | (
        splits & ((mj.split_bin != mp.split_bin) | (mj.missing_left != mp.missing_left)))
    below = np.zeros_like(differ)
    for n in range(1, differ.shape[1]):
        below[:, n] = differ[:, (n - 1) // 2] | below[:, (n - 1) // 2]
    return differ & ~below, below


def _assert_same_model(mj, mp, beta=5.0, max_tied=0):
    """Both models equal: structure exactly, values to 1e-5, histories within
    one row's weight.  ``max_tied`` allows that many nodes at which the two
    hold different splits that are tied in exact arithmetic: both send the
    same sums of ``g`` and ``h`` to the two sides (rows that share a margin
    and a label share ``g`` and ``h``, so several (feature, edge) pairs cut a
    small node into equal halves), their gains differ only by the order in
    which each package adds its f32 prefix sums, and either may come first.
    Such a node must give the same two child values in both models, in either
    order; what lies below it is not compared."""
    assert mp.num_trees == mj.num_trees
    assert mp.best_ntree_limit == mj.best_ntree_limit
    assert (mp.depth, mp.base_score) == (mj.depth, mj.base_score)
    np.testing.assert_array_equal(mj.edges, mp.edges)
    tied, below = _tied_splits(mj, mp)
    assert tied.sum() <= max_tied, np.argwhere(tied).tolist()
    for t, n in np.argwhere(tied):
        assert mj.feat[t, n] >= 0 and mp.feat[t, n] >= 0, (t, n)
        kids = slice(2 * n + 1, 2 * n + 3)
        np.testing.assert_allclose(np.sort(mp.value[t, kids]), np.sort(mj.value[t, kids]),
                                   atol=1e-5, rtol=0, err_msg=f"tied split at tree {t} node {n}")
    keep = ~below
    for name in ("feat", "is_leaf"):
        np.testing.assert_array_equal(getattr(mj, name)[keep & ~tied], getattr(mp, name)[keep & ~tied],
                                      err_msg=name)
    splits = (mj.feat >= 0) & keep & ~tied
    np.testing.assert_array_equal(mj.missing_left[splits], mp.missing_left[splits])
    np.testing.assert_array_equal(mj.split_bin[splits], mp.split_bin[splits])
    np.testing.assert_array_equal(mj.threshold[splits], mp.threshold[splits])
    np.testing.assert_allclose(mp.value[keep], mj.value[keep], atol=1e-5, rtol=0)
    for key in ("train_error", "eval_error"):
        hj, hp = np.asarray(mj.history[key]), np.asarray(mp.history[key])
        assert hj.shape == hp.shape == (mj.num_trees,)
        assert np.abs(hj - hp).max() <= beta, key               # one row's weight
    for key in ("final_train_auc", "final_eval_auc"):
        assert mp.history[key] == pytest.approx(mj.history[key], abs=1e-6 if not tied.any() else 1e-4)
    return int(tied.sum())


def _first_trees(m, n):
    """A copy of model ``m`` cut to its first ``n`` trees."""
    d = dict(vars(m))
    for k in ("feat", "threshold", "split_bin", "missing_left", "value", "is_leaf"):
        d[k] = d[k][:n]
    d["history"] = {k: (v[:n] if isinstance(v, list) else v) for k, v in m.history.items()}
    d["best_ntree_limit"] = 1
    return pgbt.GBTModel.from_arrays(d)


def test_train_gbt_ten_rounds_matches_jax():
    X, y = _gbt_data(2000, 0)
    Xe, ye = _gbt_data(500, 1)
    kw = dict(num_boost_round=10, early_stopping_rounds=10, depth=5)
    mj = jgbt.train_gbt(X, y, Xe, ye, jgbt.GBTParams(**kw), verbose_every=0)
    mp = pgbt.train_gbt(X, y, Xe, ye, pgbt.GBTParams(**kw), verbose_every=0, device="cpu")
    # 8 of the 630 nodes hold tied splits (level 4 of trees 1, 2 and 4 to 7,
    # nodes of about 60 rows): the port adds its prefix sums with
    # ``torch.cumsum``, the reference in XLA's blocks.  The port's fixed-point
    # histograms (each bin's sum rounded once, the reference's at every add)
    # left the count at 8: the bins' sums of these rows round alike either
    # way, and the ties part in the prefix sums over them
    assert _assert_same_model(mj, mp, max_tied=8) == 8
    assert mp.num_trees == 10 and mp.threshold.dtype == np.float32
    # the same forest gives the same probabilities in both packages
    mpj = pgbt.GBTModel.from_arrays(vars(mj))
    np.testing.assert_allclose(mpj.predict(Xe, device="cpu"), mj.predict(Xe), atol=1e-6)
    np.testing.assert_allclose(mpj.predict(Xe, ntree_limit=7, batch=64, device="cpu"),
                               mj.predict(Xe, ntree_limit=7), atol=1e-6)
    np.testing.assert_array_equal(mpj.feature_importance(), mj.feature_importance())
    # tied splits send unseen rows to other leaves: the two forests agree on
    # the eval rows to 0.05 in probability, and on the train rows to 0.005
    np.testing.assert_allclose(mp.predict(Xe, device="cpu"), mj.predict(Xe), atol=0.05)
    np.testing.assert_allclose(mp.predict(X, device="cpu"), mj.predict(X), atol=0.005)
    assert mp.feature_importance().shape == (8,) and mp.feature_importance().sum() == pytest.approx(1.0)


def test_train_gbt_stops_early_in_the_second_segment_as_jax():
    X, y = _gbt_data(2000, 0)
    Xe, ye = _gbt_data(500, 1)
    kw = dict(num_boost_round=120, early_stopping_rounds=5, depth=5)
    mj = jgbt.train_gbt(X, y, Xe, ye, jgbt.GBTParams(**kw), verbose_every=0)
    mp = pgbt.train_gbt(X, y, Xe, ye, pgbt.GBTParams(**kw), verbose_every=0, device="cpu")
    assert 50 < mj.num_trees < 100, "the reference must stop inside the second segment"
    assert (mp.num_trees, mp.best_ntree_limit) == (mj.num_trees, mj.best_ntree_limit)
    # tree 0 has no tied split and is the reference's; from the first tied
    # split on (tree 1, see the ten-round test) rows that the two packages sent
    # to different sides carry different margins, so later trees drift apart
    # in value: the error histories still agree within one row's weight
    _assert_same_model(_first_trees(mj, 1), _first_trees(mp, 1))
    for key in ("train_error", "eval_error"):
        hj, hp = np.asarray(mj.history[key]), np.asarray(mp.history[key])
        assert hj.shape == hp.shape and np.abs(hj - hp).max() <= 5.0, key
    assert mp.best_ntree_limit + 5 == mp.num_trees              # XGBoost's truncation


# ---------------------------------------------------------------- features

@pytest.fixture(scope="module")
def port_world(world):
    jcfg, jtruth, jtrain, jtest, actual = world
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    train = TitleSet.from_titles(jtrain.titles, ids=jtrain.ids, labels=jtrain.labels, config=cfg)
    test = TitleSet.from_titles(jtest.titles, ids=jtest.ids, config=cfg)
    return cfg, truth, train, test


@pytest.fixture(scope="module")
def pairs_both(world, port_world):
    """Training pairs of both packages on the ``world``.  The reference
    retrieves with the Pallas kernels in interpret mode (f32): every one of
    the 90 train rows has tied scores inside its top 20 (250 titles, most of
    them score 0), ``rng.sample`` draws by position, and only that path
    orders ties as the port's kernels do."""
    jcfg, jtruth, jtrain, _jtest, _actual = world
    cfg, truth, train, _test = port_world
    jc = jcfg.with_(retrieval_impl="pallas_interpret")
    pj = jtrainer.assemble_training_pairs(
        jtrain, jtruth, JScorer(jbuild_truth_index(jtruth, jc), jc), jc, random.Random(jc.seed))
    pp = ptrainer.assemble_training_pairs(
        train, truth, JaccardScorer(build_truth_index(truth, cfg), cfg, "cpu"), cfg,
        random.Random(cfg.seed))
    return pj, pp


def test_assemble_training_pairs_equal(pairs_both):
    pj, pp = pairs_both
    for name in ("kind", "target", "pair_q", "t_pos"):
        a, b = getattr(pj, name), getattr(pp, name)
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype
    assert pj.q_titles == pp.q_titles
    assert set(np.unique(pp.kind)) == {1, 2, 3}


def _pair_tables(pairs, truth, cfg):
    from doppelspeller_tpu_torch.utils import text as T

    q_enc = T.encode_titles(pairs.q_titles, cfg.max_characters)
    q_len = np.array([min(len(t), cfg.max_characters) for t in pairs.q_titles], np.int32)
    counts = ptrainer.WordCounts(truth).matrix(truth.transformed)
    return q_enc, q_len, truth.encoded, truth.lengths.astype(np.int32), counts


def _assert_features_close(fp, fj):
    np.testing.assert_array_equal(np.isnan(fp), np.isnan(fj))
    np.testing.assert_allclose(np.nan_to_num(fp), np.nan_to_num(fj), atol=1e-5)


def test_features_for_pairs_matches_jax_and_ignores_chunk_size(world, port_world, pairs_both):
    jcfg = world[0]
    cfg, truth, _train, _test = port_world
    _pj, pp = pairs_both
    sel = np.random.RandomState(6).choice(len(pp.kind), 300, replace=False)
    tables = _pair_tables(pp, truth, cfg)
    fj = jfeatures.features_for_pairs(pp.pair_q[sel], pp.t_pos[sel], *tables, jcfg)
    fp = pfeatures.features_for_pairs(pp.pair_q[sel], pp.t_pos[sel], *tables, cfg, "cpu")
    assert fp.shape == (300, pfeatures.FEATURES_COUNT) and fp.dtype == np.float32
    _assert_features_close(fp, fj)
    assert np.isnan(fp).any() and np.isfinite(fp[:, :6]).all()
    small = pfeatures.features_for_pairs(pp.pair_q[sel], pp.t_pos[sel], *tables, cfg, "cpu", chunk=37)
    np.testing.assert_array_equal(small, fp)
    assert pfeatures.features_for_pairs(sel[:0], sel[:0], *tables, cfg, "cpu").shape == (0, 66)


def test_construct_features_matches_jax_and_ignores_chunk_size(world, port_world, pairs_both):
    jcfg = world[0]
    cfg, truth, _train, _test = port_world
    _pj, pp = pairs_both
    sel = np.random.RandomState(8).choice(len(pp.kind), 300, replace=False)
    q_enc, q_len, t_enc, t_len, counts = _pair_tables(pp, truth, cfg)
    q, t = pp.pair_q[sel], pp.t_pos[sel]
    args = (q_enc[q], q_len[q], t_enc[t], t_len[t], counts[t], len(truth))
    fj = jfeatures.construct_features(*args, jcfg)
    fp = pfeatures.construct_features(*args, cfg, "cpu")
    _assert_features_close(fp, fj)
    np.testing.assert_array_equal(pfeatures.construct_features(*args, cfg, "cpu", chunk=41), fp)
    # the two entries agree with each other on the same pairs
    np.testing.assert_array_equal(
        fp, pfeatures.features_for_pairs(q, t, q_enc, q_len, t_enc, t_len, counts, cfg, "cpu"))


# ------------------------------------------------------------- train_model

def test_train_model_matches_jax_on_equal_candidates(world, port_world, tmp_path):
    """With the reference's retrieval in interpret mode both packages draw
    the same pairs, so the whole of ``train_model`` must agree: features,
    split, trees.  ``save`` writes a file the JAX package loads."""
    jcfg, jtruth, jtrain, _jtest, _actual = world
    cfg, truth, train, _test = port_world
    jc = jcfg.with_(retrieval_impl="pallas_interpret", data_path=str(tmp_path / "jax"))
    mj, rj = jtrainer.train_model(jc, train=jtrain, truth=jtruth, save=False)
    pc = cfg.with_(data_path=str(tmp_path))
    mp, rp = ptrainer.train_model(pc, train=train, truth=truth, save=True, device="cpu")
    _assert_same_model(mj, mp)
    assert rp["n_pairs"] == rj["n_pairs"] and rp["error_matrix"] == rj["error_matrix"]
    assert rp["eval_custom_error"] == rj["eval_custom_error"]
    assert set(rj) <= set(rp) and set(rj["timings"]) == set(rp["timings"])
    assert sum(rp["pairs_by_kind"].values()) == rp["n_pairs"] == rp["n_train_rows"] + rp["n_eval_rows"]
    # each package reads the other's file
    loaded = jgbt.GBTModel.load(pc.model_path)
    for name in ("feat", "threshold", "split_bin", "missing_left", "value", "is_leaf", "edges"):
        np.testing.assert_array_equal(getattr(loaded, name), getattr(mp, name), err_msg=name)
    assert (loaded.base_score, loaded.best_ntree_limit, loaded.depth) == (
        mp.base_score, mp.best_ntree_limit, mp.depth)
    jpath = str(tmp_path / "jax_model.npz")
    mj.save(jpath)
    back = pgbt.GBTModel.load(jpath)
    np.testing.assert_array_equal(back.value, mj.value)
    assert back.history == {} and back.best_ntree_limit == mj.best_ntree_limit


def test_port_trained_model_predicts_as_the_trained_fixture(world, port_world, trained):
    """The ``trained`` fixture is the reference's model from its own CPU
    retrieval (the XLA fallback), which orders tied candidates otherwise
    than the kernels do: all 90 train rows have ties in their top 20, so the
    sampled pairs and with them the two models differ.  Both still have to
    decide the test set alike: at least 95 % of the rows get the same
    ``match_title_id`` (every row that differs is decided by the model stage)."""
    jcfg, jtruth, _jtrain, jtest, actual = world
    cfg, truth, train, test = port_world
    jmodel, _ = trained
    pmodel, _ = ptrainer.train_model(cfg, train=train, truth=truth, save=False, device="cpu")
    assert pmodel.num_trees == jmodel.num_trees == 40
    rj = JMatcher(jcfg, truth=jtruth, model=jmodel, use_index_checkpoint=False).predict(jtest)
    rp = Matcher(cfg, truth=truth, model=pmodel, device="cpu").predict(test)
    same = rj.match_title_id == rp.match_title_id
    assert same.mean() >= 0.95
    assert ((rj.stage[~same] == 3) | (rp.stage[~same] == 3)).all()
    assert (rp.match_title_id == actual).mean() >= (rj.match_title_id == actual).mean() - 0.03
    # and with the reference's own model the port decides every row as the reference
    rpj = Matcher(cfg, truth=truth, model=pgbt.GBTModel.from_arrays(vars(jmodel)),
                  device="cpu").predict(test)
    compare_predictions(rj, rpj)


def test_train_model_needs_the_title_sets(port_world, tmp_path, monkeypatch):
    """Without ``train`` and ``truth`` both packages read them from the
    config's CSVs: missing files raise, and written ones load as the JAX
    package's loaders read them."""
    from doppelspeller_tpu.config import Config as JConfig
    from doppelspeller_tpu.utils import io as jio

    cfg, truth, train, _test = port_world
    cfg = cfg.with_(data_path=str(tmp_path))
    jcfg = JConfig(data_path=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        jtrainer.train_model(jcfg)
    with pytest.raises(FileNotFoundError):
        ptrainer.train_model(cfg, device="cpu")
    with open(cfg.ground_truth_path, "w") as f:
        f.write("company_id|name\n" + "".join(f"{i}|{t}\n" for i, t in zip(truth.ids, truth.titles)))
    with open(cfg.train_path, "w") as f:
        f.write("train_index|name|company_id\n" + "".join(
            f"{i}|{t}|{label}\n" for i, t, label in zip(train.ids, train.titles, train.labels)))
    seen = {}

    def stop(train_set, truth_set, *args):
        seen.update(train=train_set, truth=truth_set)
        raise KeyboardInterrupt

    monkeypatch.setattr(ptrainer, "assemble_training_pairs", stop)
    with pytest.raises(KeyboardInterrupt):
        ptrainer.train_model(cfg, device="cpu")
    for got, ref in ((seen["train"], jio.load_train_data(jcfg)), (seen["truth"], jio.load_ground_truth(jcfg))):
        assert got.titles == ref.titles and got.transformed == ref.transformed
        np.testing.assert_array_equal(got.ids, ref.ids)
        np.testing.assert_array_equal(got.encoded, ref.encoded)
    np.testing.assert_array_equal(seen["train"].labels, train.labels)


def test_quick_train_model_draws_as_the_bench(monkeypatch):
    """``synthetic.quick_train_model`` hands ``train_model`` the rows that
    ``bench.quick_train_model`` hands the reference's."""
    import bench

    jcfg, jtruth, _q, _a = bench.make_synthetic_world(1200, 8)
    cfg = port_config(jcfg)
    _, truth, _, _ = synthetic.make_synthetic_world(1200, 8, config=cfg)
    got = {}

    def jfake(config, train, truth, scorer, params, save):
        got["jax"] = (train.titles, train.labels, params.num_boost_round, params.early_stopping_rounds, save)
        return None, None

    def pfake(config, train, truth, params, save, device):
        got["port"] = (train.titles, train.labels, params.num_boost_round, params.early_stopping_rounds, save)
        got["device"] = device
        return None, None

    monkeypatch.setattr(jtrainer, "train_model", jfake)
    monkeypatch.setattr(ptrainer, "train_model", pfake)
    bench.quick_train_model(jcfg, jtruth, 7)
    synthetic.quick_train_model(cfg, truth, 7, "cpu")
    assert got["jax"][0] == got["port"][0] and len(got["port"][0]) == 1200
    np.testing.assert_array_equal(got["jax"][1], got["port"][1])
    assert got["jax"][2:] == got["port"][2:] == (7, 7, False)
    assert got["device"] == "cpu"
