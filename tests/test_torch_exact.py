"""PyTorch port, exact retrieval: the packed index and the query-block
planner, the CPU routes of kernels C, D (gather and scoring) and E against
the Pallas kernels in interpret mode, and the exact ``JaccardScorer``
against the JAX scorer (``pallas_interpret``, ``retrieval_mode="exact"``,
no truth).  The CUDA kernels themselves are compared with their plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from doppelspeller_tpu.ops.jaccard import JaccardScorer as JScorer
from doppelspeller_tpu.ops.jaccard import densify_weights as j_densify
from doppelspeller_tpu.ops.jaccard_pallas import (
    gather_rows_pallas,
    gatherable_view,
    jaccard_topk_pallas,
    jaccard_topk_pallas_v2,
    permute_sums,
)
from doppelspeller_tpu.ops.ngram_index import build_truth_index as j_build_index
from doppelspeller_tpu.ops.ngram_index import plan_query_blocks as j_plan
from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import (
    build_packed_matrix,
    build_truth_index,
    plan_query_blocks,
)
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_torch_helpers import port_config, union_inputs, untied

EXACT = dict(retrieval_mode="exact", retrieval_impl="pallas_interpret", score_dtype="float32",
             topk_recall_target=1.0)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


@pytest.fixture(scope="module", params=["world", "bench4096"])
def both_worlds(request):
    """(JAX config, JAX truth, JAX queries, port config, port truth, port queries)."""
    if request.param == "world":
        jcfg, jtruth, _train, jq, _actual = request.getfixturevalue("world")
    else:
        jcfg, jtruth, jq, _actual = bench.make_synthetic_world(4096, 512)
        jcfg = jcfg.with_(data_path="/tmp/doppel_tpu_test_data")
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    queries = TitleSet.from_titles(jq.titles, ids=jq.ids, config=cfg)
    return jcfg, jtruth, jq, cfg, truth, queries


def test_packed_matrix_equals_jax(both_worlds):
    jcfg, jtruth, _jq, cfg, truth, _q = both_worlds
    jpacked = j_build_index(jtruth, jcfg.with_(index_build_impl="host")).packed
    packed = build_packed_matrix(build_truth_index(truth, cfg), "cpu")
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), jpacked)


def test_query_block_plans_equal_jax(both_worlds):
    jcfg, jtruth, jq, cfg, truth, queries = both_worlds
    jcfg = jcfg.with_(index_build_impl="host", union_buckets=(64, 96, 128))
    jplans = j_plan(jq, j_build_index(jtruth, jcfg), jcfg)
    plans = plan_query_blocks(queries, build_truth_index(truth, cfg),
                              cfg.with_(union_buckets=(64, 96, 128)))
    assert len(plans) == len(jplans) > len(queries) // cfg.query_block     # splits happened
    for p, jp in zip(plans, jplans):
        np.testing.assert_array_equal(p.query_rows, jp.query_rows)
        np.testing.assert_array_equal(p.union_ids, jp.union_ids)
        np.testing.assert_array_equal(p.w_pos, jp.w_pos)
        np.testing.assert_array_equal(p.w_val, jp.w_val)
        np.testing.assert_array_equal(p.max_intersection, jp.max_intersection)
        assert p.n_valid == jp.n_valid


@pytest.mark.parametrize("U", [64, 96, 33])
def test_kernel_c_plain_matches_pallas_interpret(U):
    rng = np.random.default_rng(U)
    packed = rng.integers(0, 256, (301, 512), dtype=np.uint8)
    ids = rng.integers(0, 301, U).astype(np.int32)
    want = np.asarray(gather_rows_pallas(jnp.asarray(gatherable_view(packed)), jnp.asarray(ids),
                                         interpret=True))
    got = jk.gather_rows(torch.from_numpy(packed), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tb,score_dtype", [
    (128, "float32"), (2048, "float32"), (128, "bfloat16"), (2048, "bfloat16"),
])
def test_kernel_d_plain_matches_pallas_interpret(tb, score_dtype):
    qb, U, V, ntp, nt, k = 16, 96, 400, 4096, 4000, 40
    packed, union_ids, w, sums, maxint = union_inputs(tb, qb, U, V, ntp, nt)
    jdt = jnp.float32 if score_dtype == "float32" else jnp.bfloat16
    vj, pj = jaccard_topk_pallas_v2(
        jnp.asarray(packed), jnp.asarray(permute_sums(sums, tb)), jnp.asarray(w).astype(jdt),
        jnp.asarray(maxint), jnp.asarray(union_ids), jnp.int32(nt), k=k, tb=tb, uc=32,
        score_dtype=score_dtype, interpret=True, recall_target=1.0, window_select=False,
    )
    _check_d_against(vj, pj, packed, union_ids, w, sums, maxint, nt, k, tb, score_dtype)


def _check_d_against(vj, pj, packed, union_ids, w, sums, maxint, nt, k, tb, score_dtype):
    """Kernel D's CPU route (gather, then the plain scoring) and its exact
    top-k against the reference's top-k (vj, pj)."""
    vj, pj = np.asarray(vj), np.asarray(pj)
    jacc = jk.score_full(*(torch.from_numpy(a) for a in (packed, union_ids, w, sums, maxint)), nt,
                         tb=tb, score_dtype=score_dtype)
    assert jacc.dtype == (torch.float32 if score_dtype == "float32" else torch.bfloat16)
    vp, pp = jk.select_topk_permuted(jacc, k, tb)
    vp, pp = vp.numpy(), pp.numpy()
    if score_dtype == "float32":
        np.testing.assert_allclose(vp, vj, rtol=1e-5, atol=0)
        mask = untied(vj)
        assert mask.mean() > 0.5
        np.testing.assert_array_equal(pp[mask], pj[mask])
    else:
        assert (np.abs(vp - vj) <= bf16_ulp(vj)).all()


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_kernel_d_repeated_and_padding_ids_match_pallas_interpret(score_dtype):
    """A union whose ids repeat, each copy weighted, and that holds padding
    rows (id 0, no weight) inside and at its end: D reads every repeat as
    the reference's gather does."""
    qb, U, V, ntp, nt, k, tb = 12, 80, 200, 4096, 3950, 30, 2048
    packed, union_ids, w, sums, maxint = union_inputs(21, qb, U, V, ntp, nt)
    union_ids[10:30] = union_ids[40:60]
    union_ids[0:3] = union_ids[3]
    union_ids[60:64] = 0
    w[:, 60:64] = 0.0
    assert len(np.unique(union_ids)) < U - 25 and (w[:, 10:30] > 0).any()
    jdt = jnp.float32 if score_dtype == "float32" else jnp.bfloat16
    vj, pj = jaccard_topk_pallas_v2(
        jnp.asarray(packed), jnp.asarray(permute_sums(sums, tb)), jnp.asarray(w).astype(jdt),
        jnp.asarray(maxint), jnp.asarray(union_ids), jnp.int32(nt), k=k, tb=tb, uc=16,
        score_dtype=score_dtype, interpret=True, recall_target=1.0, window_select=False,
    )
    _check_d_against(vj, pj, packed, union_ids, w, sums, maxint, nt, k, tb, score_dtype)


@pytest.mark.parametrize("tb", [128, 2048])
def test_kernel_d_exact_ties_positions_equal_everywhere(tb):
    qb, U, V, ntp, nt, k = 16, 64, 300, 4096, 3900, 60
    packed, union_ids, w, sums, maxint = union_inputs(7, qb, U, V, ntp, nt, integer=True)
    vj, pj = jaccard_topk_pallas_v2(
        jnp.asarray(packed), jnp.asarray(permute_sums(sums, tb)), jnp.asarray(w),
        jnp.asarray(maxint), jnp.asarray(union_ids), jnp.int32(nt), k=k, tb=tb, uc=64,
        score_dtype="float32", interpret=True, recall_target=1.0, window_select=False,
    )
    vp, pp = jk.select_topk_permuted(
        jk.score_full(*(torch.from_numpy(a) for a in (packed, union_ids, w, sums, maxint)), nt,
                      tb=tb, score_dtype="float32"), k, tb)
    vj = np.asarray(vj)
    assert (~untied(vj, 0.0)).mean() > 0.9                   # almost every slot is tied
    np.testing.assert_array_equal(vp.numpy(), vj)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))


@pytest.mark.parametrize("score_dtype,integer,ntp,nt,k,tb", [
    ("float32", False, 2048, 2000, 25, 128),
    ("bfloat16", False, 2048, 2000, 25, 128),
    ("float32", True, 2048, 2000, 25, 128),
    ("float32", False, 2048, 20, 25, 128),        # nt < k: padding candidates at -1
    ("float32", False, 4096, 3001, 40, 2048),     # nt inside a title tile
    # integer weights: ties across kernel E's 8,192-title ranges, the last
    # range partial, nt inside a tile
    ("float32", True, 16384 + 2048, 17000, 60, 2048),
    ("bfloat16", True, 16384, 16384, 100, 2048),
])
def test_kernel_e_plain_matches_pallas_interpret(score_dtype, integer, ntp, nt, k, tb):
    qb, U, V, lq = 8, 64, 300, 12
    packed, union_ids, w, sums, maxint = union_inputs(11 + ntp, qb, U, V, ntp, nt, integer=integer)
    rng = np.random.default_rng(5)
    w_pos = np.full((qb, lq), U, np.int32)
    w_val = np.zeros((qb, lq), np.float32)
    for q in range(qb - 1):                                  # the last query is padding
        n = rng.integers(3, lq + 1)
        w_pos[q, :n] = np.sort(rng.choice(U - 5, n, replace=False))
        w_val[q, :n] = w[q, w_pos[q, :n]] + 0.5
    w_pos[1, 1] = U                                          # a padding slot between weighted ones
    vj, pj = jaccard_topk_pallas(
        jnp.asarray(packed), jnp.asarray(permute_sums(sums, tb)), jnp.asarray(union_ids),
        jnp.asarray(w_pos), jnp.asarray(w_val), jnp.asarray(maxint), jnp.int32(nt),
        k=k, tb=tb, score_dtype=score_dtype, interpret=True,
    )
    vj, pj = np.asarray(vj), np.asarray(pj)
    dense = jk.densify_weights(torch.from_numpy(w_pos), torch.from_numpy(w_val), U)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(j_densify(jnp.asarray(w_pos), jnp.asarray(w_val), U, jnp.float32)))
    vp, pp = jk.jaccard_topk_v1(
        *(torch.from_numpy(a) for a in (packed, sums, union_ids, w_pos, w_val, maxint)), nt,
        k=k, tb=tb, score_dtype=score_dtype)
    np.testing.assert_allclose(vp.numpy(), vj, rtol=1e-5, atol=0)
    mask = np.ones_like(vj, bool) if integer else untied(vj)
    # with 20 real titles many scores tie at 0, and the padding ties at -1
    assert mask.mean() > (0.2 if nt < k else 0.5)
    np.testing.assert_array_equal(pp.numpy()[mask], pj[mask])
    if nt < k:
        # the padding candidates tie at -1: the reference's column order
        assert (vj[:, nt:] == -1).all()
        np.testing.assert_array_equal(pp.numpy()[:, nt:], pj[:, nt:])


@pytest.mark.parametrize("integer,tb,ntp,k", [
    (False, 2048, 3 * 8192, 100),
    (True, 2048, 2 * 8192 + 4096, 100),   # ties across the ranges, the last range partial
    (True, 128, 8192 + 2048, 300),         # a range of fewer than k titles
    (False, 32, 4096, 1),
])
def test_range_candidates_merge_to_select_topk_permuted(integer, tb, ntp, k):
    """Kernel E's reduction: each 8,192-title range keeps its own top-k
    keys (``score_keys``; INT64_MIN past a short range's titles), and the
    top-k of all ranges' keys (``select_topk_keys``) is the exact top-k of
    the whole π-ordered matrix, ties included."""
    qb, U, V, nt = 6, 48, 200, ntp - 700
    packed, union_ids, w, sums, maxint = union_inputs(k + tb, qb, U, V, ntp, nt, integer=integer)
    jacc = jk.score_full_plain(jk.gather_rows_plain(torch.from_numpy(packed), torch.from_numpy(union_ids)),
                               torch.from_numpy(w), torch.from_numpy(sums), torch.from_numpy(maxint),
                               nt, tb=tb, out_dtype=torch.float32)
    keys = jk.score_keys(jacc)
    cut = []
    for r0 in range(0, ntp, 8192):
        part = keys[:, r0 : r0 + 8192]
        top = torch.topk(part, min(k, part.shape[1]), dim=1).values
        cut.append(torch.nn.functional.pad(top, (0, k - top.shape[1]), value=torch.iinfo(torch.int64).min))
    vm, pm = jk.select_topk_keys(torch.cat(cut, dim=1), k, tb)
    vs, ps = jk.select_topk_permuted(jacc, k, tb)
    assert torch.equal(vm, vs) and torch.equal(pm, ps)
    if integer:
        assert (~untied(vs.numpy(), 0.0)).mean() > 0.5      # mostly ties
    # scores read back from the keys are the matrix's own
    cols = jk.unpermute_positions(torch.arange(ntp), tb)
    natural = torch.empty_like(jacc)
    natural[:, cols] = jacc
    assert torch.equal(torch.gather(natural, 1, ps.to(torch.int64)), vs)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    qb, U, V, ntp, nt, tb = 4, 32, 64, 2048, 2000, 2048
    packed, union_ids, w, sums, maxint = union_inputs(3, qb, U, V, ntp, nt)
    packed, union_ids, w, sums, maxint = (torch.from_numpy(a) for a in (packed, union_ids, w, sums, maxint))
    w_pos = torch.arange(8, dtype=torch.int32).repeat(qb, 1)
    counters = (jk.gather_rows, jk.score_full, jk.jaccard_topk_v1)
    before = [f.launches for f in counters]
    jk.gather_rows(packed, union_ids)
    jk.score_full(packed, union_ids, w, sums, maxint, nt, tb=tb, score_dtype="bfloat16")
    jk.jaccard_topk_v1(packed, sums, union_ids, w_pos, w[:, :8], maxint, nt, k=5, tb=tb,
                       score_dtype="float32")
    assert [f.launches for f in counters] == before


@pytest.fixture(scope="module")
def exact_scorers(world):
    jcfg, jtruth, _train, jtest, _actual = world
    jcfg = jcfg.with_(**EXACT)
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    test = TitleSet.from_titles(jtest.titles, ids=jtest.ids, config=cfg)
    out = {}
    for ws in (False, True):
        js = JScorer(j_build_index(jtruth, jcfg), jcfg.with_(retrieval_window_select=ws))
        ps = JaccardScorer(build_truth_index(truth, cfg), cfg.with_(retrieval_window_select=ws), "cpu")
        assert ps.exact is not None and ps.folded is None
        out[ws] = (js, ps)
    return jcfg, jtest, test, out


@pytest.mark.parametrize("window_select", [False, True])
def test_exact_scorer_matches_jax(exact_scorers, window_select):
    jcfg, jtest, test, scorers = exact_scorers
    js, ps = scorers[window_select]
    vj, pj = js.topk(jtest, k=jcfg.top_n_predicting)
    vp, pp = ps.topk(test, k=jcfg.top_n_predicting)
    np.testing.assert_allclose(vp, vj, rtol=1e-5, atol=1e-6)
    mask = untied(vj, 1e-7)
    assert mask.any()
    np.testing.assert_array_equal(pp[mask], pj[mask])


def test_exact_scorer_rows_subset(exact_scorers):
    jcfg, jtest, test, scorers = exact_scorers
    js, ps = scorers[False]
    rows = np.array([3, 1, 40, 77, 12, 55, 9, 60, 2, 31])
    vj, pj = js.topk(jtest, k=10, rows=rows)
    ps.exact.union_sizes.clear()
    vp, pp = ps.topk(test, k=10, rows=rows)
    plans = plan_query_blocks(test, ps.index, ps.cfg, rows=rows)
    assert ps.exact.union_sizes == Counter(p.union_ids.shape[0] for p in plans)
    np.testing.assert_allclose(vp, vj, rtol=1e-5, atol=1e-6)
    mask = untied(vj, 1e-7)
    np.testing.assert_array_equal(pp[mask], pj[mask])
    full_v, _ = ps.topk(test, k=10)
    np.testing.assert_array_equal(vp, full_v[rows])


def test_exact_scorer_duplicate_titles_tie_order(world):
    """Truth titles repeated at several positions score exactly equal: the
    order among them is the reference's π column order."""
    jcfg, jtruth, _train, jtest, _actual = world
    jcfg = jcfg.with_(retrieval_window_select=False, **EXACT)
    titles = list(jtruth.titles[:90]) * 3
    jt = type(jtruth).from_titles(titles, ids=np.arange(len(titles)), config=jcfg)
    js = JScorer(j_build_index(jt, jcfg), jcfg)
    cfg = port_config(jcfg)
    ps = JaccardScorer(build_truth_index(TitleSet.from_titles(titles, ids=np.arange(len(titles)),
                                                              config=cfg), cfg), cfg, "cpu")
    test = TitleSet.from_titles(jtest.titles, ids=jtest.ids, config=cfg)
    vj, pj = js.topk(jtest, k=12)
    vp, pp = ps.topk(test, k=12)
    np.testing.assert_allclose(vp, vj, rtol=1e-5, atol=1e-6)
    assert (~untied(vj, 0.0)).mean() > 0.5
    np.testing.assert_array_equal(pp, pj)


def test_default_exact_block_equals_jax_and_never_calls_gather_rows(world, monkeypatch):
    """``ExactEngine.topk_block`` under the default config (bf16 weights,
    window select) hands kernel A the packed index and the union's ids: it
    equals the JAX scorer, positions exact wherever the scores are untied,
    and ``gather_rows`` is never called."""
    jcfg, jtruth, _train, jtest, _actual = world
    jcfg = jcfg.with_(retrieval_mode="exact", retrieval_impl="pallas_interpret",
                      score_dtype="bfloat16")               # the default, which the world overrides
    assert jcfg.retrieval_window_select
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    test = TitleSet.from_titles(jtest.titles, ids=jtest.ids, config=cfg)
    js = JScorer(j_build_index(jtruth, jcfg), jcfg)
    ps = JaccardScorer(build_truth_index(truth, cfg), cfg, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("the exact path called gather_rows")

    monkeypatch.setattr(jk, "gather_rows", refuse)
    seen = []
    real = jk.score_window_select

    def spy(rows_u8, *args, union_ids=None, **kwargs):
        seen.append((rows_u8.data_ptr(), None if union_ids is None else union_ids.shape[0]))
        return real(rows_u8, *args, union_ids=union_ids, **kwargs)

    monkeypatch.setattr(jk, "score_window_select", spy)
    k = jcfg.top_n_predicting
    plans = plan_query_blocks(test, ps.index, cfg)
    vp, pp = zip(*(ps.exact.topk_block(p, k) for p in plans))
    assert seen == [(ps.exact.packed.data_ptr(), p.union_ids.shape[0]) for p in plans]
    vp = np.concatenate([v.numpy()[: p.n_valid] for v, p in zip(vp, plans)])
    pp = np.concatenate([x.numpy()[: p.n_valid] for x, p in zip(pp, plans)])
    vj, pj = js.topk(jtest, k=k)
    # bf16 weights, f32 sums in another order
    np.testing.assert_allclose(vp, vj, rtol=1e-5, atol=1e-6)
    mask = untied(vj, 1e-6)
    assert mask.mean() > 0.3
    np.testing.assert_array_equal(pp[mask], pj[mask])


@pytest.mark.parametrize("window_select", [False, True])
@pytest.mark.parametrize("bad", [-1, "V"])
def test_exact_block_refuses_union_ids_outside_the_index(exact_scorers, window_select, bad):
    """The kernels read ``packed[id]`` unchecked, so ``topk_block`` holds a
    plan's ids to [0, V) while they are on the host."""
    _jcfg, _jtest, test, scorers = exact_scorers
    _js, ps = scorers[window_select]
    plan = plan_query_blocks(test, ps.index, ps.cfg)[0]
    ids = plan.union_ids.copy()
    ids[-1] = ps.exact.packed.shape[0] if bad == "V" else bad
    with pytest.raises(ValueError, match="outside the packed index"):
        ps.exact.topk_block(dataclasses.replace(plan, union_ids=ids), 10)
