"""PyTorch port, retrieval: kernel A's plain version against the Pallas
kernel in interpret mode, the folded ``JaccardScorer`` against the JAX
scorer, and how a scorer resolves its mode.  The CUDA kernel itself is
compared with its plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doppelspeller_tpu.ops.jaccard import JaccardScorer as JScorer
from doppelspeller_tpu.ops.jaccard_pallas import jaccard_topk_pallas_v2, permute_sums
from doppelspeller_tpu.ops.ngram_index import build_truth_index as j_build_index
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.ops import jaccard as jaccard_module
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.jaccard_kernels import (
    score_window_select,
    score_window_select_plain,
    select_topk_windowed,
)
from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
from doppelspeller_tpu_torch.pipeline import Matcher
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import MODEL, port_config, untied


def _kernel_inputs(seed, qb, C, folds, ntp, nt):
    rng = np.random.default_rng(seed)
    U = folds * C
    rows = (rng.random((U, ntp // 8, 8)) < 0.08)
    rows = np.packbits(rows, axis=2, bitorder="little")[:, :, 0]
    w = (rng.random((qb, U)) * 3.0).astype(np.float32)
    w[rng.random((qb, U)) < 0.9] = 0.0
    sums = (rng.random(ntp) * 40.0 + 5.0).astype(np.float32)
    sums[nt:] = 0.0
    maxint = (rng.random(qb) * 30.0 + 5.0).astype(np.float32)
    return rows, w, sums, maxint


@pytest.mark.parametrize("tb,W,folds,score_dtype", [
    (2048, 16, 1, "float32"),
    (2048, 16, 2, "float32"),
    (128, 1, 1, "float32"),
    (128, 1, 2, "float32"),
    (2048, 16, 2, "bfloat16"),
])
def test_kernel_a_plain_matches_pallas_interpret(tb, W, folds, score_dtype):
    qb, C, ntp, nt, k = 16, 64, 4096, 4000, 48
    rows, w, sums, maxint = _kernel_inputs(tb + folds, qb, C, folds, ntp, nt)
    jdt = jnp.float32 if score_dtype == "float32" else jnp.bfloat16
    vj, pj = jaccard_topk_pallas_v2(
        jnp.asarray(rows), jnp.asarray(permute_sums(sums, tb)), jnp.asarray(w).astype(jdt),
        jnp.asarray(maxint), None, jnp.int32(nt), k=k, tb=tb, uc=C, score_dtype=score_dtype,
        interpret=True, recall_target=1.0, window_select=True, folds=folds,
    )
    vj, pj = np.asarray(vj), np.asarray(pj)
    wmax, warg = score_window_select(
        torch.from_numpy(rows), torch.from_numpy(w), torch.from_numpy(sums),
        torch.from_numpy(maxint), nt, tb=tb, W=W, folds=folds, score_dtype=score_dtype,
    )
    assert wmax.shape == (qb, ntp // W) and warg.dtype == torch.int32
    vp, pp = select_topk_windowed(wmax, warg, k)
    np.testing.assert_allclose(vj, vp.numpy(), rtol=1e-5, atol=1e-6)
    mask = untied(vj)
    assert mask.mean() > 0.5
    np.testing.assert_array_equal(pj[mask], pp.numpy()[mask])


def test_kernel_a_window_grouping_and_padding():
    """Each window's title is the first offset of the reference grouping
    reaching the window max, and padded titles score −1."""
    tb, W, nt = 2048, 16, 1500
    rows, w, sums, maxint = _kernel_inputs(1, 4, 32, 1, tb, nt)
    wmax, warg = score_window_select_plain(
        torch.from_numpy(rows), torch.from_numpy(w), torch.from_numpy(sums),
        torch.from_numpy(maxint), nt, tb=tb, W=W, folds=1)
    bits = np.unpackbits(rows, axis=1, bitorder="little").astype(np.float64)
    num = w.astype(np.float64) @ bits
    jacc = num / np.maximum(sums[None] + maxint[:, None] - num, 1e-9)
    jacc[:, nt:] = -1
    S, nb = tb // W, tb // 8
    for s in (0, 5, 127):
        titles = [8 * ((o * S + s) % nb) + (o * S + s) // nb for o in range(W)]
        sc = jacc[:, titles]
        np.testing.assert_allclose(wmax[:, s].numpy(), sc.max(axis=1), rtol=1e-5)
        want = np.array(titles)[np.argmax(sc >= sc.max(axis=1, keepdims=True) - 1e-12, axis=1)]
        np.testing.assert_array_equal(warg[:, s].numpy(), want)
    assert (wmax.numpy() <= 1.0).all()


@pytest.fixture(scope="module")
def scorers(world):
    jcfg, jtruth, _train, jtest, _actual = world
    jcfg = jcfg.with_(retrieval_mode="folded", fold_hashes=2, retrieval_impl="pallas_interpret",
                      score_dtype="float32")
    js = JScorer(j_build_index(jtruth, jcfg), jcfg, truth=jtruth)
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    test = TitleSet.from_titles(jtest.titles, ids=jtest.ids, config=cfg)
    ps = JaccardScorer(build_truth_index(truth, cfg), cfg, "cpu", truth)
    return jcfg, js, jtest, ps, test


def test_folded_scorer_matches_jax(scorers):
    jcfg, js, jtest, ps, test = scorers
    vj, pj = js.topk(jtest, k=jcfg.top_n_predicting)
    vp, pp = ps.topk(test, k=jcfg.top_n_predicting)
    np.testing.assert_allclose(vj, vp, rtol=1e-5, atol=1e-6)
    mask = untied(vj, 1e-7)
    assert mask.any()
    np.testing.assert_array_equal(pj[mask], pp[mask])


def test_folded_scorer_rows_subset(scorers):
    jcfg, js, jtest, ps, test = scorers
    rows = np.array([3, 1, 40, 77, 12])
    vj, pj = js.topk(jtest, k=10, rows=rows)
    vp, pp = ps.topk(test, k=10, rows=rows)
    np.testing.assert_allclose(vj, vp, rtol=1e-5, atol=1e-6)
    mask = untied(vj, 1e-7)
    np.testing.assert_array_equal(pj[mask], pp[mask])


def test_folded_matcher_builds_no_packed_matrix(world, monkeypatch):
    jcfg, jtruth, *_ = world
    cfg = port_config(jcfg, retrieval_mode="folded")
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)

    def refuse(*args, **kwargs):
        raise AssertionError("the folded path built the packed (V, ntp/8) matrix")

    monkeypatch.setattr(jaccard_module, "build_packed_matrix", refuse)
    matcher = Matcher(cfg, truth=truth, model=GBTModel.load(str(MODEL)), device="cpu")
    assert matcher.scorer.folded is not None and matcher.scorer.exact is None


def test_folded_without_truth_raises_and_auto_without_truth_is_exact(world):
    jcfg, jtruth, *_ = world
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    index = build_truth_index(truth, cfg)
    with pytest.raises(ValueError):
        JaccardScorer(index, cfg.with_(retrieval_mode="folded"), "cpu")
    # as the trainer builds it: no truth, so "auto" stays exact at any size
    scorer = JaccardScorer(index, cfg.with_(retrieval_mode="auto", folded_min_titles=1), "cpu")
    assert scorer.exact is not None and scorer.folded is None
    with pytest.raises(ValueError):
        JaccardScorer(index, cfg.with_(retrieval_mode="approximate"), "cpu", truth)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rows, w, sums, maxint = _kernel_inputs(0, 4, 32, 2, 2048, 2000)
    before = score_window_select.launches
    score_window_select(torch.from_numpy(rows), torch.from_numpy(w), torch.from_numpy(sums),
                        torch.from_numpy(maxint), 2000, tb=2048, W=16, folds=2, score_dtype="float32")
    assert score_window_select.launches == before
