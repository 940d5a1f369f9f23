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
    gather_rows,
    kernel_a_weights,
    score_window_select,
    score_window_select_plain,
    select_topk_windowed,
    split_weights,
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


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_kernel_a_weight_parts_sum_to_the_weights(score_dtype):
    """f32: hi + mid + lo reproduces every f32 weight of the IDF range
    exactly; bf16: the one part is the rounded weight."""
    rng = np.random.default_rng(11)
    w = (rng.random((64, 4096)) * 12.0).astype(np.float32)
    w[rng.random(w.shape) < 0.3] = 0.0
    w[0, :8] = [0.0, 12.0, 1e-3, 7.0 / 3.0, 0.1, 11.999999, 2.0 ** -20, 5.5]
    parts = split_weights(torch.from_numpy(w), score_dtype)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3 if score_dtype == "float32" else 1, *w.shape)
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.float()
    want = w if score_dtype == "float32" else torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(total.numpy(), want)


@pytest.mark.parametrize("folds,C,qb", [(2, 70, 37), (1, 130, 150)])
def test_kernel_a_weight_image_layout(folds, C, qb):
    """The image holds each part's weight where the kernel reads it: query
    n and row k of chunk c of fold f at element 1024·(k//8) + 64·(n//8) +
    8·(n%8) + k%8 of its 16 KB tile; padding is zero."""
    rng = np.random.default_rng(folds)
    w = (rng.random((qb, folds * C)) * 10.0).astype(np.float32)
    img = kernel_a_weights(torch.from_numpy(w), folds, "float32")
    parts = split_weights(torch.from_numpy(w), "float32").float().numpy()
    P, nqb, nch = 3, -(-qb // 128), -(-C // 64)
    assert img.shape == (P, folds, nqb, nch, 8, 16, 8, 8)
    flat = img.float().numpy().reshape(-1)
    p, f, q, r = np.meshgrid(np.arange(P), np.arange(folds), np.arange(nqb * 128),
                             np.arange(nch * 64), indexing="ij")
    tile = ((p * folds + f) * nqb + q // 128) * nch + r // 64
    n, k = q % 128, r % 64
    got = flat[tile * 8192 + 1024 * (k // 8) + 64 * (n // 8) + 8 * (n % 8) + k % 8]
    want = np.zeros_like(got)
    want[:, :, :qb, :C] = parts.reshape(P, qb, folds, C).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("folds", [1, 2])
def test_kernel_a_three_parts_match_plain_and_pallas_interpret(folds):
    """Scoring with the weights the f32 kernel contracts (the sum of the
    three bf16 parts read back from its image) equals the plain f32 version
    and the Pallas kernel in interpret mode."""
    tb, W = 2048, 16
    qb, C, ntp, nt, k = 16, 64, 4096, 4000, 48
    rows, w, sums, maxint = _kernel_inputs(tb + folds, qb, C, folds, ntp, nt)
    img = kernel_a_weights(torch.from_numpy(w), folds, "float32").float()
    # (P, folds, 1, 1, 8, 16, 8, 8) → (P, queries, folds·C)
    parts = img[:, :, 0, 0].permute(0, 3, 4, 1, 2, 5).reshape(3, 128, folds * 64)[:, :qb]
    w_img = parts[0] + parts[1] + parts[2]
    args = (torch.from_numpy(rows), w_img, torch.from_numpy(sums), torch.from_numpy(maxint), nt)
    wi, ai = score_window_select_plain(*args, tb=tb, W=W, folds=folds)
    wp, ap = score_window_select_plain(torch.from_numpy(rows), torch.from_numpy(w), *args[2:],
                                       tb=tb, W=W, folds=folds)
    assert torch.equal(wi, wp) and torch.equal(ai, ap)
    vj, pj = jaccard_topk_pallas_v2(
        jnp.asarray(rows), jnp.asarray(permute_sums(sums, tb)), jnp.asarray(w), jnp.asarray(maxint),
        None, jnp.int32(nt), k=k, tb=tb, uc=C, score_dtype="float32", interpret=True,
        recall_target=1.0, window_select=True, folds=folds,
    )
    vi, pi = select_topk_windowed(wi, ai, k)
    np.testing.assert_allclose(np.asarray(vj), vi.numpy(), rtol=1e-5, atol=1e-6)
    mask = untied(np.asarray(vj))
    assert mask.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(pj)[mask], pi.numpy()[mask])


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


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("U", [64, 83, 130])
def test_kernel_a_with_union_ids_equals_the_call_on_gathered_rows(U, score_dtype):
    """``score_window_select`` on the packed index with ``union_ids`` (ids
    that repeat, the padding id 0 inside and at the end, U off the 64-row
    step) equals, exactly, the call on the gathered rows."""
    qb, V, ntp, nt, tb, W = 9, 300, 4096, 4000, 2048, 16
    rng = np.random.default_rng(U)
    packed = rng.integers(0, 256, (V, ntp // 8), dtype=np.uint8)
    ids = rng.integers(1, V, U).astype(np.int32)
    ids[5:15] = ids[20:30]                                   # repeats, each copy weighted
    ids[40:43] = 0
    ids[U - 4:] = 0
    w = (rng.random((qb, U)) * 3.0).astype(np.float32)
    w[rng.random((qb, U)) < 0.8] = 0.0
    w[:, 40:43] = 0.0
    w[:, U - 4:] = 0.0
    sums = (rng.random(ntp) * 40.0 + 5.0).astype(np.float32)
    sums[nt:] = 0.0
    packed, ids, w, sums, maxint = (torch.from_numpy(a) for a in
                                    (packed, ids, w, sums, w.sum(axis=1)))
    kw = dict(tb=tb, W=W, folds=1, score_dtype=score_dtype)
    before = (score_window_select.launches, score_window_select.gathered, gather_rows.launches)
    wi, ai = score_window_select(packed, w, sums, maxint, nt, union_ids=ids, **kw)
    wr, ar = score_window_select(packed[ids.long()], w, sums, maxint, nt, **kw)
    assert wi.shape == (qb, ntp // W)
    assert torch.equal(wi, wr) and torch.equal(ai, ar)
    assert (wi > 0).any()
    # CPU tensors: the plain versions, no launch counted anywhere
    assert before == (score_window_select.launches, score_window_select.gathered,
                      gather_rows.launches)


def test_kernel_a_union_ids_need_one_fold_and_matching_weights():
    rows, w, sums, maxint = (torch.from_numpy(a) for a in _kernel_inputs(2, 4, 32, 2, 2048, 2000))
    ids = torch.arange(64, dtype=torch.int32)
    kw = dict(tb=2048, W=16, score_dtype="float32")
    with pytest.raises(ValueError):
        score_window_select(rows, w, sums, maxint, 2000, folds=2, union_ids=ids, **kw)
    with pytest.raises(ValueError):                          # w has 64 columns, the union 10 ids
        score_window_select(rows, w, sums, maxint, 2000, folds=1, union_ids=ids[:10], **kw)
    with pytest.raises(TypeError):
        score_window_select(rows, w, sums, maxint, 2000, folds=1, union_ids=ids[None], **kw)
