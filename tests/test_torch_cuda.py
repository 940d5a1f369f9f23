"""PyTorch port, CUDA kernels against their plain versions on the card.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips (the kernels have no CPU mode; their
plain versions are held equal to the JAX package by the other
``test_torch_*`` files).  Kernels: A (window select), B (sliding-window
LCS), C (row gather), D (full Jaccard matrix), E (sparse weights, exact
top-k), F (whole-title LCS, bit for bit ``lcs_plain``, in a CUDA graph
too) and G (the folded select and exact rescore, bit for bit
``select_rescore_plain``, in the folded scorer's graphs too).  D's and E's kernels, and A with ``union_ids``, read the union's
rows straight from the packed index; the tests hold them against the plain
gather and scoring.  The one-dispatch path's graph replays are held
against the same program run op by op, bit for bit, and the truth index
built on the card (``ops/index_device.py``) against the host build.  The
single card's graphs (retrieval, fuzzy and model stages) against its run
op by op, bit for bit (two k on one scorer too), its host launches a
predict, the program's spans around its graph launches and fetches, and a
failed capture.  The mesh
(``parallel/sharded.py``) on two shards of the card: a stream each,
graphs captured once per shard and shape, the single card's bits.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from doppelspeller_tpu_torch.ops import features_kernels as fk
from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
from doppelspeller_tpu_torch.ops import levenshtein as lev

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _a_inputs(seed, qb, C, folds, ntp, nt, device):
    rng = np.random.default_rng(seed)
    U = folds * C
    rows = np.packbits(rng.random((U, ntp // 8, 8)) < 0.06, axis=2, bitorder="little")[:, :, 0]
    w = (rng.random((qb, U)) * 8.0).astype(np.float32)
    w[rng.random((qb, U)) < 0.93] = 0.0
    sums = (rng.random(ntp) * 50.0 + 10.0).astype(np.float32)
    sums[nt:] = 0.0
    # the bound is at least any intersection, as on the real path, so no
    # denominator comes near zero (where summation order alone moves scores)
    maxint = w.sum(axis=1)
    return [torch.from_numpy(x).to(device) for x in (rows, w, sums, maxint)]


@pytest.mark.parametrize("folds,C,qb,score_dtype", [
    (2, 512, 37, "float32"),
    (2, 512, 37, "bfloat16"),
    (2, 500, 37, "bfloat16"),     # rows per fold not a multiple of the 64-row step
    (2, 512, 150, "bfloat16"),    # two blocks of 128 queries
    (1, 1000, 37, "float32"),
    (1, 1536, 128, "bfloat16"),   # the exact path's union sizes
    (1, 3072, 128, "bfloat16"),
    (1, 3072, 128, "float32"),
])
def test_kernel_a_matches_plain(cuda, folds, C, qb, score_dtype):
    tb, W, nt = 2048, 16, 60_000
    rows, w, sums, maxint = _a_inputs(C + folds, qb, C, folds, 1 << 16, nt, cuda)
    before = jk.score_window_select.launches
    wk, ak = jk.score_window_select(rows, w, sums, maxint, nt, tb=tb, W=W, folds=folds,
                                    score_dtype=score_dtype)
    assert jk.score_window_select.launches == before + 1
    wr = jk.round_weights(w, score_dtype)
    wp, ap = jk.score_window_select_plain(rows, wr, sums, maxint, nt, tb=tb, W=W, folds=folds)
    torch.cuda.synchronize()
    # both modes: exact products (0/1 bits times bf16 parts), f32 sums in
    # another order
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-7)
    untied = jk.untied_windows(rows, wr, sums, maxint, nt, tb=tb, W=W, folds=folds, rtol=1e-5)
    assert untied.float().mean() > 0.5
    assert torch.equal(ak[untied], ap[untied])
    # padded tiles: -1 at offset 0 (tile-local title 8·s)
    first_pad_tile = -(-nt // tb)
    pad = slice(first_pad_tile * (tb // W), None)
    assert (wk[:, pad] == -1).all() and torch.equal(ak[:, pad], ap[:, pad])


def test_kernel_a_rejects_what_it_does_not_take(cuda):
    rows, w, sums, maxint = _a_inputs(0, 8, 64, 2, 1 << 14, 10_000, cuda)
    with pytest.raises(ValueError):
        jk.score_window_select(rows[:, ::2], w, sums[::2], maxint, 100, tb=2048, W=16, folds=2,
                               score_dtype="float32")
    with pytest.raises(ValueError):
        jk.score_window_select(rows, w, sums, maxint, 100, tb=4096, W=16, folds=2,
                               score_dtype="float32")
    # the kernel is built for tb = 2048, W = 16, the only tiling any path
    # uses; other windows raise rather than fall back to the plain version
    for tb, W in ((128, 1), (1024, 8)):
        with pytest.raises(ValueError):
            jk.score_window_select(rows, w, sums, maxint, 100, tb=tb, W=W, folds=2,
                                   score_dtype="float32")


@pytest.mark.parametrize("U,qb,ntp,nt,score_dtype", [
    (37, 37, 1 << 14, 15_950, "float32"),        # nt inside a tile, tiles wholly past it
    (37, 128, 1 << 15, 20_000, "bfloat16"),
    (1000, 128, 1 << 16, 60_000, "bfloat16"),    # U not a multiple of the 64-row step
    (1000, 200, 1 << 16, 65_536, "float32"),     # two query blocks, no padding title
    (3072, 128, 1 << 16, 65_000, "float32"),
    (3072, 200, 1 << 16, 60_000, "bfloat16"),
])
def test_kernel_a_gathers_the_union_rows(cuda, U, qb, ntp, nt, score_dtype):
    """A with ``union_ids`` (repeated and padding ids) on the packed index:
    bit-equal to A on the gathered rows (the same sums in the same order),
    and equal to the plain gather and plain A as A is on rows."""
    tb, W = 2048, 16
    packed, ids, w, sums, maxint = _d_inputs(U + qb, qb, U, 4000, ntp, nt, cuda)
    kw = dict(tb=tb, W=W, folds=1)
    counters = (jk.score_window_select, jk.gather_rows)
    before = [c.launches for c in counters] + [jk.score_window_select.gathered]
    wk, ak = jk.score_window_select(packed, w, sums, maxint, nt, score_dtype=score_dtype,
                                    union_ids=ids, **kw)
    assert ([c.launches for c in counters] + [jk.score_window_select.gathered]
            == [before[0] + 1, before[1], before[2] + 1])
    rows = jk.gather_rows_plain(packed, ids)
    wu, au = jk.score_window_select(rows, w, sums, maxint, nt, score_dtype=score_dtype, **kw)
    assert jk.score_window_select.gathered == before[2] + 1       # no ids, none counted
    wr = jk.round_weights(w, score_dtype)
    wp, ap = jk.score_window_select_plain(rows, wr, sums, maxint, nt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(wk, wu) and torch.equal(ak, au)
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-7)
    untied = jk.untied_windows(rows, wr, sums, maxint, nt, rtol=1e-5, **kw)
    assert untied.any()
    assert torch.equal(ak[untied], ap[untied])


def test_kernel_a_takes_ids_with_one_fold_only(cuda):
    packed, ids, w, sums, maxint = _d_inputs(1, 8, 64, 100, 1 << 12, 4000, cuda)
    with pytest.raises(ValueError):
        jk.score_window_select(packed, w, sums, maxint, 4000, tb=2048, W=16, folds=2,
                               score_dtype="float32", union_ids=ids)
    with pytest.raises(ValueError):                   # an empty union
        jk.score_window_select(packed, w[:, :0], sums, maxint, 4000, tb=2048, W=16, folds=1,
                               score_dtype="float32", union_ids=ids[:0])


@pytest.mark.parametrize("U,nbytes", [(1024, 8192), (37, 16), (3, 48), (300, 65_536 + 48)])
def test_kernel_c_equals_index_select(cuda, U, nbytes):
    g = torch.Generator(device="cuda").manual_seed(U)
    src = torch.randint(0, 256, (500, nbytes), device=cuda, generator=g, dtype=torch.int32).to(torch.uint8)
    ids = torch.randint(0, 500, (U,), device=cuda, generator=g)
    before = jk.gather_rows.launches
    out = jk.gather_rows(src, ids)
    assert jk.gather_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, jk.gather_rows_plain(src, ids))


def _d_inputs(seed, qb, U, V, ntp, nt, device):
    """A packed index u8 (V, ntp/8), a union of U ids that repeat (at random
    and in one copied run, every copy weighted) and end in padding rows (id
    0, no weight), weights f32 (qb, U), sums f32 (ntp,) and the real path's
    bound maxint f32 (qb,), at least every intersection, so no denominator
    comes near zero (where summation order alone moves scores)."""
    rng = np.random.default_rng(seed)
    packed = np.packbits(rng.random((V, ntp // 8, 8)) < 0.1, axis=2, bitorder="little")[:, :, 0]
    ids = rng.integers(0, V, U).astype(np.int32)
    ids[U // 3 : U // 3 + U // 8] = ids[: U // 8]
    n_pad = min(5, U // 4)
    ids[U - n_pad :] = 0
    w = (rng.random((qb, U)) * 8.0).astype(np.float32)
    w[rng.random((qb, U)) < (0.9 if U >= 1000 else 0.5)] = 0.0
    w[:, U - n_pad :] = 0.0
    sums = (rng.random(ntp) * 50.0 + 10.0).astype(np.float32)
    sums[nt:] = 0.0
    maxint = w.sum(axis=1)
    return [torch.from_numpy(x).to(device) for x in (packed, ids, w, sums, maxint)]


@pytest.mark.parametrize("U,qb,tb,ntp,nt,score_dtype", [
    (37, 37, 128, 1 << 14, 15_950, "float32"),       # nt inside a tile, blocks wholly past it
    (37, 128, 2048, 1 << 15, 20_000, "bfloat16"),
    (1000, 128, 2048, 1 << 16, 60_000, "bfloat16"),
    (1000, 37, 128, 1 << 16, 40_000, "bfloat16"),
    (1000, 200, 128, (1 << 16) + 128, 65_600, "float32"),   # rows of 513 x 16 bytes
    (3072, 128, 2048, 1 << 16, 65_000, "float32"),
    (3072, 200, 2048, 1 << 16, 60_000, "bfloat16"),  # two query blocks
    (3072, 37, 2048, 1 << 16, 1 << 16, "float32"),   # no padding title
])
def test_kernel_d_matches_plain(cuda, U, qb, tb, ntp, nt, score_dtype):
    packed, ids, w, sums, maxint = _d_inputs(U + qb + tb, qb, U, 4000, ntp, nt, cuda)
    before = (jk.score_full.launches, jk.gather_rows.launches)
    out = jk.score_full(packed, ids, w, sums, maxint, nt, tb=tb, score_dtype=score_dtype)
    assert (jk.score_full.launches, jk.gather_rows.launches) == (before[0] + 1, before[1])
    plain = jk.score_full_plain(jk.gather_rows_plain(packed, ids), jk.round_weights(w, score_dtype),
                                sums, maxint, nt, tb=tb, out_dtype=jk.score_out_dtype(score_dtype))
    torch.cuda.synchronize()
    assert out.dtype == plain.dtype and out.shape == (qb, ntp)
    vp, pp = jk.select_topk_permuted(plain, 100, tb)
    if score_dtype == "float32":
        # exact products (0/1 bits times exact weight parts), f32 sums in
        # another order
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-7)
        sep = jk.untied_slots(vp, 1e-6)
    else:
        # one bf16 ulp: the two f32 sums may round to neighbouring bf16 values
        ulp = torch.exp2(torch.floor(torch.log2(plain.float().abs().clamp(min=1e-30))) - 7)
        assert ((out.float() - plain.float()).abs() <= ulp).all()
        sep = jk.untied_slots(vp, float(2 * ulp.max()))
    assert (out.float()[:, jk.unpermute_positions(torch.arange(ntp, device=cuda), tb) >= nt] == -1).all()
    vk, pk = jk.select_topk_permuted(out, 100, tb)
    if score_dtype == "float32":
        assert sep.float().mean() > 0.5
    else:
        # bf16 scores keep 8 significant bits, so these inputs tie by design:
        # 0.2-2.6 % of their top-100 slots stand two ulps clear
        assert sep.any()
    assert torch.equal(pk[sep], pp[sep])


def test_kernel_d_rejects_what_it_does_not_take(cuda):
    packed, ids, w, sums, maxint = _d_inputs(0, 8, 64, 100, 1 << 12, 4000, cuda)
    with pytest.raises(ValueError):                   # tiles of a multiple of 64 titles only
        jk.score_full(packed, ids, w, sums, maxint, 4000, tb=32, score_dtype="float32")
    with pytest.raises(ValueError):                   # an empty union
        jk.score_full(packed, ids[:0], w[:, :0], sums, maxint, 4000, tb=2048, score_dtype="float32")
    with pytest.raises(ValueError):
        jk.score_full(packed, ids, w[:, 1:], sums, maxint, 4000, tb=2048, score_dtype="float32")


def _e_inputs(seed, qb, U, lq, ntp, nt, device, integer=False):
    """Kernel E's arguments: a packed index, a union of U ids, per query up
    to lq distinct positions (the last queries partly padding slots U),
    weights, sums and the real path's bound (at least every intersection).
    With ``integer`` the weights and sums are small integers and every
    title copies one of 24, so scores tie exactly, across E's title ranges
    too."""
    packed, union_ids, _w, sums, _maxint = _d_inputs(seed, qb, U, 4000, ntp, nt, device)
    g = torch.Generator(device=device).manual_seed(seed)
    w_pos = torch.sort(torch.rand((qb, U - 5), device=device, generator=g).argsort(dim=1)[:, :lq],
                       dim=1).values.to(torch.int32)
    w_pos[-3:, lq // 2:] = U                                          # padding slots
    w_val = torch.rand((qb, lq), device=device, generator=g) * 6.0
    if integer:
        w_val = torch.floor(w_val) + 1.0
        sums = torch.floor(sums)
        src = torch.randint(0, 24, (ntp,), device=device, generator=g)
        bits = torch.stack([(packed >> s) & 1 for s in range(8)], dim=2).reshape(packed.shape[0], ntp)
        bits = bits[:, src].reshape(packed.shape[0], ntp // 8, 8)
        packed = (bits << torch.arange(8, device=device, dtype=torch.uint8)).sum(dim=2).to(torch.uint8)
        sums = sums[src]
        sums[nt:] = 0.0
    maxint = jk.densify_weights(w_pos, w_val, U).sum(dim=1) + 1.0
    return packed, sums, union_ids, w_pos, w_val, maxint, nt


@pytest.mark.parametrize("score_dtype,qb,lq,tb,ntp,nt,k,integer", [
    ("float32", 64, 40, 2048, 1 << 17, 100_000, 100, False),
    ("bfloat16", 64, 40, 2048, 1 << 17, 100_000, 100, False),
    ("float32", 37, 40, 2048, 1 << 17, 60, 100, False),           # nt < k: padding candidates
    ("float32", 128, 64, 128, (1 << 16) + 2048, 65_000, 128, False),  # a partial last range
    ("float32", 20, 253, 32, 1 << 14, 12_345, 128, False),        # nt inside a tile; the planner's largest LQ
    ("float32", 16, 24, 2048, 1 << 16, 60_000, 100, True),        # ties across the title ranges
    ("bfloat16", 16, 24, 128, 1 << 15, 30_000, 64, True),
])
def test_kernel_e_matches_plain(cuda, score_dtype, qb, lq, tb, ntp, nt, k, integer):
    args = _e_inputs(qb + lq + tb, qb, 2048, lq, ntp, nt, cuda, integer=integer)
    counters = (jk.jaccard_topk_v1, jk.gather_rows, jk.score_full)
    before = [c.launches for c in counters]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    vk, pk = jk.jaccard_topk_v1(*args, k=k, tb=tb, score_dtype=score_dtype)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    # E's own kernel: no launch of C or D, and no (QB, ntp) score matrix
    assert [c.launches for c in counters] == [before[0] + 1, before[1], before[2]]
    assert peak < qb * ntp * 4 / 4
    vp, pp = jk.jaccard_topk_v1_plain(*args, k=k, tb=tb, score_dtype=score_dtype)
    torch.cuda.synchronize()
    if integer:
        # every score an exact ratio of small integers: equal everywhere,
        # ties and their order included
        assert torch.equal(vk, vp) and torch.equal(pk, pp)
        assert (~jk.untied_slots(vp, 0.0)).float().mean() > 0.5
        return
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=1e-7)
    sep = jk.untied_slots(vp, 1e-6)
    assert sep.float().mean() > 0.5 or nt < k
    assert torch.equal(pk[sep], pp[sep])
    if nt < k:
        assert (vk[:, nt:] == -1).all() and torch.equal(pk[:, nt:], pp[:, nt:])


def test_kernel_e_rejects_what_it_does_not_take(cuda):
    packed, sums, ids, w_pos, w_val, maxint, nt = _e_inputs(0, 8, 64, 16, 1 << 14, 10_000, cuda)
    for kw in (dict(tb=16, k=10), dict(tb=96, k=10), dict(tb=16384, k=10), dict(tb=2048, k=0),
               dict(tb=2048, k=(1 << 14) + 1)):
        with pytest.raises(ValueError):
            jk.jaccard_topk_v1(packed, sums, ids, w_pos, w_val, maxint, nt, score_dtype="float32",
                               **kw)
    wide = torch.full((8, 257), 64, dtype=torch.int32, device=cuda)     # LQ past 256
    with pytest.raises(ValueError):
        jk.jaccard_topk_v1(packed, sums, ids, wide, wide.float(), maxint, nt, k=10, tb=2048,
                           score_dtype="float32")


def _b_inputs(seed, B, TL, WL, device):
    rng = np.random.RandomState(seed)
    q_wo = rng.randint(2, 9, (B, TL)).astype(np.uint8)
    q_wo_len = rng.randint(0, TL + 1, B).astype(np.int32)
    q_wo[np.arange(TL)[None, :] >= q_wo_len[:, None]] = 0
    wlen = rng.randint(0, WL + 1, (B, 15)).astype(np.int32)
    wlen[:, 6:] = 0
    chars = (rng.randint(2, 9, (B, 15, WL)) * (np.arange(WL) < wlen[:, :, None])).astype(np.uint8)
    return [torch.from_numpy(x).to(device) for x in (chars, wlen, q_wo, q_wo_len)]


@pytest.mark.parametrize("TL,WL", [(32, 8), (64, 16), (64, 32), (128, 32)])
def test_kernel_b_matches_plain_exactly(cuda, TL, WL):
    args = _b_inputs(TL + WL, 3000, TL, WL, cuda)
    before = fk.window_best.launches
    rk, pk = fk.window_best(*args)
    assert fk.window_best.launches == before + 1
    rp, pp = fk.window_best_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(rk, rp)
    assert torch.equal(pk, pp)


def _b_edge_inputs(seed, B, TL, WL, device):
    """Random pairs with the edges mixed in: empty pairs (qwol 0), qwol of 1,
    TL and past TL, pairs with all 15 slots full, words of length 0, 1 and
    WL, and a pair whose windows all tie (one repeated character)."""
    rng = np.random.RandomState(seed)
    q_wo = rng.randint(2, 9, (B, TL)).astype(np.uint8)
    q_wo_len = rng.randint(0, TL + 1, B).astype(np.int32)
    q_wo_len[:8] = [0, 1, TL, TL + 5, TL, 2, TL - 1, 0]
    wlen = rng.randint(0, WL + 1, (B, 15)).astype(np.int32)
    wlen[:, 6:] = 0
    wlen[2:5] = rng.randint(1, WL + 1, (3, 15))          # every slot full
    wlen[5, :4] = [WL, 1, 0, WL]
    chars = rng.randint(2, 9, (B, 15, WL))
    # windows that tie: the first p wins
    q_wo[6], chars[6], wlen[6, :3] = 3, 3, [1, min(4, WL), min(WL, TL - 1)]
    q_wo[np.arange(TL)[None, :] >= q_wo_len[:, None]] = 0
    chars = (chars * (np.arange(WL) < wlen[:, :, None])).astype(np.uint8)
    return [torch.from_numpy(x).to(device) for x in (chars, wlen, q_wo, q_wo_len)]


@pytest.mark.parametrize("B,TL,WL", [
    (3001, 16, 8), (3001, 32, 16), (1023, 64, 32), (9, 64, 16), (517, 32, 32), (3001, 64, 8),
    (130, 96, 32),
])
def test_kernel_b_ragged_shapes_and_edges_match_plain_exactly(cuda, B, TL, WL):
    args = _b_edge_inputs(B + TL + WL, B, TL, WL, cuda)
    rk, pk = fk.window_best(*args)
    rp, pp = fk.window_best_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(rk, rp)
    assert torch.equal(pk, pp)
    assert (rk[0] == -1).all() and (pk[0] == 0).all()               # an empty query
    assert (rk[2:5] >= 0).all()                                     # full slots
    assert (pk[6, :3] == 0).all() and (rk[6, :3] == 100).all()      # ties keep p = 0


def test_kernel_b_word_slots_beyond_a_warp(cuda):
    """More word slots than lanes: the slots go in groups of 32."""
    rng = np.random.RandomState(3)
    B, W, TL, WL = 65, 40, 32, 16
    q_wo = torch.from_numpy(rng.randint(2, 9, (B, TL)).astype(np.uint8)).to(cuda)
    q_wo_len = torch.from_numpy(rng.randint(0, TL + 1, B).astype(np.int32)).to(cuda)
    wlen = rng.randint(0, WL + 1, (B, W)).astype(np.int32)
    chars = (rng.randint(2, 9, (B, W, WL)) * (np.arange(WL) < wlen[:, :, None])).astype(np.uint8)
    args = (torch.from_numpy(chars).to(cuda), torch.from_numpy(wlen).to(cuda), q_wo, q_wo_len)
    rk, pk = fk.window_best(*args)
    rp, pp = fk.window_best_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(rk, rp) and torch.equal(pk, pp)


def test_kernel_b_every_length_and_common_count(cuda):
    """Every word length 1..32 against every query length 1..64 with every
    count k of characters the two share (the word is k times 'a', then 'b';
    the query is all 'a'), so that every ratio the kernel's division can
    meet is held against the plain version's."""
    wl, ql, k = np.meshgrid(np.arange(1, 33), np.arange(1, 65), np.arange(0, 33), indexing="ij")
    keep = k <= wl
    wl, ql, k = wl[keep], ql[keep], k[keep]
    n = -(-len(wl) // 15) * 15
    wl, ql, k = (np.resize(a, n) for a in (wl, ql, k))
    # the 15 slots of a pair share its query: sort so that they share ql
    order = np.lexsort((k, wl, ql))
    wl, ql, k = wl[order].reshape(-1, 15), ql[order].reshape(-1, 15), k[order].reshape(-1, 15)
    q_len = ql[:, 0]
    wl = np.where(ql == q_len[:, None], wl, 0)               # a slot of another query: empty
    chars = np.where(np.arange(32) < k[:, :, None], 2, 3) * (np.arange(32) < wl[:, :, None])
    q_wo = np.where(np.arange(64)[None, :] < q_len[:, None], 2, 0)
    args = [torch.from_numpy(a).to(cuda) for a in
            (chars.astype(np.uint8), wl.astype(np.int32), q_wo.astype(np.uint8), q_len.astype(np.int32))]
    rk, pk = fk.window_best(*args)
    rp, pp = fk.window_best_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(rk, rp) and torch.equal(pk, pp)
    assert len(torch.unique(rp)) > 90                        # of the 102 values -1..100


# ------------------------------------------------------------------ kernel F

def _f_inputs(seed, B, La, Lb, alphabet, device, len_dtype=torch.int64):
    """Random pairs padded with zeros past their lengths (up to 8 past the
    width), with the edges in the first rows: lengths 0, full and past the
    width, an all-pad row, identical strings and an empty b."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, alphabet + 1, (B, La)).astype(np.uint8)
    b = rng.integers(1, alphabet + 1, (B, Lb)).astype(np.uint8)
    la = rng.integers(0, La + 9, B)
    lb = rng.integers(0, Lb + 9, B)
    if B >= 6 and La == Lb:
        la[:6] = [0, La, La + 13, La, La - 1, La // 2]
        lb[:6] = [Lb // 2, Lb, Lb, Lb + 3, La - 1, 0]
        a[3] = 0                                        # all pad under a full length
        b[4] = a[4]                                     # identical strings
    a[np.arange(La)[None, :] >= la[:, None]] = 0
    b[np.arange(Lb)[None, :] >= lb[:, None]] = 0
    la, lb = la.astype(np.int64), lb.astype(np.int64)
    out = [torch.from_numpy(x).to(device) for x in (a, la, b, lb)]
    out[1], out[3] = out[1].to(len_dtype), out[3].to(len_dtype)
    return out


@pytest.mark.parametrize("B,La,Lb,alphabet,len_dtype", [
    (4096, 32, 32, 37, torch.int64),      # a fuzzy chunk's tile at TL 32
    (4096, 64, 64, 37, torch.int32),      # the features' tile, int32 lengths
    (2048, 128, 128, 37, torch.int64),
    (1024, 255, 255, 37, torch.int64),    # the host redo's widest bucket
    (1024, 256, 256, 5, torch.int32),
    (777, 40, 200, 37, torch.int64),      # ragged widths, La != Lb
    (1000, 64, 64, 2, torch.int64),       # long LCS: carries across every word
    (300, 64, 64, 255, torch.int64),      # codes past the alphabet match their equals
    (129, 64, 64, 37, torch.int64),       # not a multiple of a block's pairs
    (1, 64, 64, 37, torch.int32),
    (0, 64, 64, 37, torch.int64),
])
def test_kernel_f_equals_plain_exactly(cuda, B, La, Lb, alphabet, len_dtype):
    args = _f_inputs(B + La + Lb + alphabet, B, La, Lb, alphabet, cuda, len_dtype)
    before = lev.lcs.launches
    got = lev.lcs(*args)
    assert lev.lcs.launches == before + (B > 0)
    want = lev.lcs_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if B >= 6 and La == Lb:
        assert got[0] == 0 and got[5] == 0 and got[3] == 0 and got[4] == args[1][4]


def test_kernel_f_takes_strided_rows(cuda):
    """Column slices of wider tensors, as the fuzzy stage passes its tiles:
    each side's row stride is the kernel's own, with no copy."""
    a, la, b, lb = _f_inputs(11, 3000, 96, 96, 37, cuda)
    a_s, b_s = a[1:, :64], b[1:, 3:63]        # b's rows start off a 4-byte boundary
    la, lb = la[1:].clamp(max=70), lb[1:].clamp(max=70)
    assert not a_s.is_contiguous() and not b_s.is_contiguous()
    got = lev.lcs(a_s, la, b_s, lb)
    want = lev.lcs_plain(a_s.contiguous(), la, b_s.contiguous(), lb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernel_f_rejects_what_it_does_not_take(cuda):
    a, la, b, lb = _f_inputs(12, 64, 64, 64, 37, cuda)
    bad = [
        (TypeError, (a.to(torch.int32), la, b, lb)),            # characters not uint8
        (TypeError, (a, la.float(), b, lb)),                    # lengths neither int32 nor int64
        (ValueError, (a, la.cpu(), b, lb)),                     # mixed devices
        (ValueError, (a, la, b.cpu(), lb)),
        (ValueError, (a[:, ::2], la, b[:, ::2], lb)),           # characters not contiguous
        (ValueError, (a, la, b, lb[:32])),                      # shape mismatch
        (ValueError, (torch.zeros((64, 257), dtype=torch.uint8, device=cuda), la, b, lb)),
    ]
    before = lev.lcs.launches
    for exc, args in bad:
        with pytest.raises(exc):
            lev.lcs(*args)
    wide = torch.zeros((4, 512), dtype=torch.int64, device=cuda)[:, ::128]
    with pytest.raises(ValueError):                             # lengths not contiguous
        lev.lcs(a[:4], wide[:, 0], b[:4], lb[:4])
    assert lev.lcs.launches == before


def test_kernel_f_replays_in_a_cuda_graph(cuda):
    """Captured in a CUDA graph (no allocation, no sync inside), replayed on
    new inputs copied into the captured tensors: equal to the eager call."""
    args = _f_inputs(13, 12_800, 64, 64, 37, cuda)
    static = [t.clone() for t in args]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        lev.lcs(*static)                                        # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lev.lcs(*static)
    for seed in (14, 15):
        fresh = _f_inputs(seed, 12_800, 64, 64, 37, cuda)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, lev.lcs(*fresh))
        assert torch.equal(out, lev.lcs_plain(*fresh))


# ---------------------------------------------------------------- kernel G

def _g_inputs(seed, qb, nw, lq, ltw, nt, kp, device):
    """Kernel G's inputs at a folded block's shape (16 titles a window):
    window maxima in [0, 1) with a run of equal values across the k'
    boundary, -1 past nt, one row of one value throughout and one of -0.0
    and +0.0 under a few higher; titles as kernel A gives them (a window's tile), some past
    nt; ids from a small vocabulary (many hits), V and weight 0 past each
    row's trigrams, all-padding rows; a row's top two titles given one
    trigram list and sum (equal rescored values)."""
    rng = np.random.default_rng(seed)
    from doppelspeller_tpu_torch.config import TRIGRAM_VOCAB_SIZE as V

    ntp = 16 * nw
    wmax = rng.random((qb, nw), dtype=np.float32)
    wmax[:, (16 * np.arange(nw)) >= nt] = -1.0
    order = np.argsort(-wmax, axis=1, kind="stable")
    for q in range(qb):                              # 20 above the boundary, 40 below
        wmax[q, order[q, max(kp - 20, 0): kp + 40]] = wmax[q, order[q, max(kp - 20, 0)]]
    if qb > 2:
        wmax[2] = 0.25
    if qb > 3:                                       # -0.0 and +0.0 compare equal
        wmax[3] = np.where(rng.random(nw) < 0.5, -0.0, 0.0)
        wmax[3, rng.integers(0, nw, kp // 2)] = 0.5
    warg = (16 * np.arange(nw)[None, :] + rng.integers(0, 16, (qb, nw))).astype(np.int32)
    ids = rng.integers(0, 400, (qb, lq))
    n_real = rng.integers(1, lq + 1, qb)
    n_real[1 % qb] = 0
    ids[np.arange(lq)[None, :] >= n_real[:, None]] = V
    w_val = np.where(ids == V, 0.0, rng.random((qb, lq)) * 8 + 0.5).astype(np.float32)
    maxint = w_val.sum(axis=1, dtype=np.float32)
    tl = rng.integers(0, 400, (ntp, ltw)).astype(np.int32)
    tl[np.arange(ltw)[None, :] >= rng.integers(1, ltw + 1, ntp)[:, None]] = V
    tl[nt:] = V
    sums = (rng.random(ntp, dtype=np.float32) * 40 + 10).astype(np.float32)
    sums[nt:] = 0.0
    top = np.argsort(-wmax, axis=1, kind="stable")[:, :2]
    for q in range(qb):
        a, b = warg[q, top[q, 0]], warg[q, top[q, 1]]
        if a < nt and b < nt:
            tl[b], sums[b] = tl[a], sums[a]
    t = [torch.from_numpy(x).to(device) for x in (wmax, warg, tl, sums)]
    return t + [torch.from_numpy(ids).to(device), torch.from_numpy(w_val).to(device),
                torch.from_numpy(maxint).to(device)]


@pytest.mark.parametrize("qb,nw,lq,ltw,nt,kp,k", [
    (128, 32_768, 64, 64, 500_000, 128, 100),     # the 500k block
    (1, 32_768, 128, 64, 500_000, 128, 100),
    (8, 32_768, 253, 64, 500_000, 128, 100),
    (8, 32_768, 64, 40, 300_000, 128, 100),       # many titles past nt
    (37, 2_048, 64, 24, 30_000, 128, 10),
    (4, 128, 64, 64, 2_000, 128, 100),            # k' = every window
    (3, 65_536, 64, 64, 1_000_000, 1_024, 1_024),   # k' past 32 a warp
])
def test_kernel_g_equals_plain_exactly(cuda, qb, nw, lq, ltw, nt, kp, k):
    from doppelspeller_tpu_torch.ops import fold

    args = _g_inputs(qb + nw + lq, qb, nw, lq, ltw, nt, kp, cuda)
    before = fold.select_rescore.launches
    vals, pos = fold.select_rescore(*args, nt, kp, k)
    assert fold.select_rescore.launches == before + 1
    pv, pp = fold.select_rescore_plain(*args, nt, kp, k)
    torch.cuda.synchronize()
    assert vals.shape == (qb, k) and pos.dtype == torch.int32
    assert torch.equal(vals.view(torch.int32), pv.view(torch.int32)) and torch.equal(pos, pp)
    assert bool((vals[:, :-1] >= vals[:, 1:]).all())
    if qb > 1:                                   # the all-padding row: 0 for real titles
        assert bool((vals[1] == torch.where(pos[1] < nt, 0.0, -1.0)).all())


def test_kernel_g_rejects_what_it_does_not_take(cuda):
    from doppelspeller_tpu_torch.ops import fold

    args = _g_inputs(5, 4, 2_048, 64, 64, 30_000, 128, cuda)
    wmax, warg, tl, sums, ids, w_val, maxint = args
    bad = [
        (TypeError, (wmax.half(), *args[1:]), 128, 10),
        (TypeError, (*args[:4], ids.int(), *args[5:]), 128, 10),
        (ValueError, (*args[:4], ids.repeat(1, 5)[:, :257].contiguous(),
                      w_val.repeat(1, 5)[:, :257].contiguous(), maxint), 128, 10),   # LQ past 256
        (ValueError, args, 2_048, 10),                               # k' past 1,024
        (ValueError, (wmax, warg, tl[:, :62], *args[3:]), 128, 10),  # Ltw not a multiple of 4
        (ValueError, (wmax[:, ::2], warg[:, ::2], *args[2:]), 128, 10),   # not contiguous
        (ValueError, (*args[:3], sums.cpu(), *args[4:]), 128, 10),   # mixed devices
        (ValueError, args, 128, 0),                                  # k of 0
    ]
    before = fold.select_rescore.launches
    for exc, a, kp, k in bad:
        with pytest.raises(exc):
            fold.select_rescore(*a, 30_000, kp, k)
    assert fold.select_rescore.launches == before


def test_kernel_g_replays_in_the_folded_graphs_and_counts_them(mesh_world):
    """The folded scorer's blocks captured as CUDA graphs (kernel A, then G)
    replay to the op-by-op run's results bit for bit, and G's counter adds
    one launch a block in every run, replays included; the exact engine
    launches no G."""
    from doppelspeller_tpu_torch.ops import fold
    from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
    from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
    from doppelspeller_tpu_torch.ops.tiles import query_block

    cfg, truth, queries = mesh_world
    for mode in ("folded", "exact"):
        c = cfg.with_(retrieval_mode=mode)
        sc = JaccardScorer(build_truth_index(truth, c), c, "cuda", truth)
        per_run = -(-len(queries) // query_block(c, folded=True)) if mode == "folded" else 0
        w = sc.workers
        w.use_graphs = False
        before = fold.select_rescore.launches
        v0, p0 = sc.topk(queries)
        assert fold.select_rescore.launches == before + per_run
        w.use_graphs = True
        for _ in range(3):                           # op by op, captured, replayed
            before = fold.select_rescore.launches
            v1, p1 = sc.topk(queries)
            assert fold.select_rescore.launches == before + per_run
            assert np.array_equal(_bits(v0), _bits(v1)) and np.array_equal(p0, p1)
        assert sum(w.replays["topk"]) > 0
        sc.close()


# ------------------------------------------------------------------ training

def _train_data(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8).astype(np.float32)
    y = (2.0 * X[:, 0] - 1.5 * X[:, 2] + 0.5 * X[:, 4] + 0.3 * rng.randn(n) > 0).astype(np.float32)
    X[(rng.rand(n) < 0.3) & (y == 1), 1] = np.nan
    return X, y


def test_build_tree_on_the_card_equals_the_cpu(cuda):
    """g in multiples of 1/8 and h = 1: every sum is exact, so the card's
    tree equals the CPU's in structure; values to 1e-6."""
    from doppelspeller_tpu_torch.models import gbt

    X, _ = _train_data(3000, 0)
    bins = torch.from_numpy(gbt.bin_features(X, gbt.compute_bin_edges(X)))
    rng = np.random.RandomState(1)
    g = torch.from_numpy((np.round((np.sign(X[:, 0]) * 2 + rng.randn(3000)) * 8) / 8).astype(np.float32))
    h = torch.ones(3000)
    kw = dict(depth=5, lambda_=1.0, min_child_weight=1.0)
    cpu = gbt.build_tree(bins, g, h, **kw)
    card = gbt.build_tree(bins.to(cuda), g.to(cuda), h.to(cuda), **kw)
    for a, b in zip(cpu[:3] + cpu[4:5], card[:3] + card[4:5]):
        assert torch.equal(a, b.cpu())
    torch.testing.assert_close(card[3].cpu(), cpu[3], atol=1e-6, rtol=0)
    torch.testing.assert_close(card[5].cpu(), cpu[5], atol=1e-6, rtol=0)


def test_train_gbt_on_the_card_learns_as_the_cpu(cuda):
    """20 rounds on the card against the same on the CPU: AUCs within 1e-3
    and the last eval errors within 5 % of the eval rows' weight (the
    histograms are the CPU's bit for bit, but the card's f32 totals and
    prefix sums add in another order and its sigmoid differs in the last
    bit, so trees may part ways where splits tie); the forest walk of one
    model gives the same probabilities on both devices to 1e-6."""
    from doppelspeller_tpu_torch.models import gbt

    X, y = _train_data(4000, 2)
    Xe, ye = _train_data(1000, 3)
    params = gbt.GBTParams(num_boost_round=20, early_stopping_rounds=20)
    a = gbt.train_gbt(X, y, Xe, ye, params, verbose_every=0, device=cuda)
    c = gbt.train_gbt(X, y, Xe, ye, params, verbose_every=0, device="cpu")
    assert a.num_trees == c.num_trees == 20
    np.testing.assert_array_equal(a.edges, c.edges)
    assert abs(a.history["final_eval_auc"] - c.history["final_eval_auc"]) < 1e-3
    assert abs(a.history["eval_error"][-1] - c.history["eval_error"][-1]) <= 0.05 * len(ye)
    np.testing.assert_allclose(a.predict(Xe, device=cuda), a.predict(Xe, device="cpu"), atol=1e-6)


def test_train_gbt_on_the_card_repeats(cuda):
    """Two trainings on the card give the same trees bit for bit: the
    histograms add in fixed point, so the order of the atomics does not
    reach them; the rows in another order give the same first tree."""
    from doppelspeller_tpu_torch.models import gbt

    X, y = _train_data(6000, 4)
    Xe, ye = _train_data(1000, 5)
    params = gbt.GBTParams(num_boost_round=30, early_stopping_rounds=30)
    a = gbt.train_gbt(X, y, Xe, ye, params, verbose_every=0, device=cuda)
    b = gbt.train_gbt(X, y, Xe, ye, params, verbose_every=0, device=cuda)
    assert a.num_trees == b.num_trees == 30
    for name in ("feat", "split_bin", "missing_left", "value", "is_leaf", "threshold"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    bins = gbt.bin_features(X, gbt.compute_bin_edges(X))
    g, h = gbt.margin_grad_hess(torch.zeros(len(y)), torch.from_numpy(y), 5.0)
    perm = np.random.RandomState(6).permutation(len(y))
    kw = dict(depth=5, lambda_=1.0, min_child_weight=1.0)
    t1 = gbt.build_tree(*(torch.as_tensor(x).to(cuda) for x in (bins, g, h)), **kw)
    t2 = gbt.build_tree(*(torch.as_tensor(x).to(cuda) for x in (bins[perm], g[perm], h[perm])), **kw)
    for u, v in zip(t1[:5], t2[:5]):
        assert torch.equal(u, v)


def test_features_for_pairs_on_the_card_equals_the_cpu(cuda):
    """The training feature matrix on the card (kernel B, WL buckets from 8
    on) equals the CPU's plain path: ratios and counts exactly, the IDF
    columns to 1e-5."""
    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.models.trainer import WordCounts
    from doppelspeller_tpu_torch.ops import features
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world

    cfg, truth, queries, _ = make_synthetic_world(2000, 400, config=Config(data_path="data"))
    rng = np.random.RandomState(4)
    pq, pt = rng.randint(0, 400, 3000), rng.randint(0, 2000, 3000)
    counts = WordCounts(truth).matrix(truth.transformed)
    args = (pq, pt, queries.encoded, queries.lengths, truth.encoded, truth.lengths, counts, cfg)
    before, before_f = fk.window_best.launches, lev.lcs.launches
    card = features.features_for_pairs(*args, cuda)
    assert fk.window_best.launches > before and lev.lcs.launches > before_f
    cpu = features.features_for_pairs(*args, "cpu")
    np.testing.assert_array_equal(np.isnan(card), np.isnan(cpu))
    np.testing.assert_array_equal(np.nan_to_num(card[:, :36]), np.nan_to_num(cpu[:, :36]))
    np.testing.assert_allclose(np.nan_to_num(card), np.nan_to_num(cpu), atol=1e-5)


# ------------------------------------------------- the one-dispatch path

@pytest.fixture(scope="module")
def serve_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the one-dispatch path replays CUDA graphs")
    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world

    cfg, truth, queries, _ = make_synthetic_world(4096, 256, config=Config(data_path="data"))
    return cfg, truth, queries


def _serve_matcher(serve_world, mode):
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher
    from test_torch_helpers import MODEL

    cfg, truth, _ = serve_world
    torch.backends.cuda.matmul.allow_tf32 = False
    return Matcher(cfg.with_(retrieval_mode=mode, query_block=8), truth, GBTModel.load(str(MODEL)),
                   device="cuda")


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint8)


@pytest.mark.parametrize("mode", ["exact", "folded"])
def test_fused_replay_equals_eager(serve_world, mode):
    """A request's graph, captured on the scorer's workers at its first
    request (which answers with the capture's op-by-op warm-up), and its
    replay at a second request of the same key each equal the request's
    ``fused_cascade`` run op by op, bit for bit, on both engines; the
    warm-up and the replay each count one launch of A."""
    from doppelspeller_tpu_torch.utils.io import TitleSet

    _cfg, _truth, queries = serve_world
    m = _serve_matcher(serve_world, mode)
    fs, w = m._fused_engine(), m.scorer.workers
    assert fs.mode == mode and fs.qb == 8
    blocks = [TitleSet.from_titles(queries.titles[s : s + 8], config=fs.cfg) for s in range(0, 256, 8)]
    keys = [fs.request(b, np.arange(8))[1] for b in blocks]
    first = blocks[0]
    again = next(b for b, k in zip(blocks[1:], keys[1:]) if k == keys[0])
    for n, block in enumerate((first, again)):
        a = jk.score_window_select.launches
        got = fs.dispatch(block, np.arange(8))
        assert (w.captures["FusedServe"], w.replays.get("FusedServe", [0])) == ([1], [n])
        assert jk.score_window_select.launches - a == 1
        ref = fs.dispatch(block, np.arange(8), eager=True)
        assert np.array_equal(got[0], ref[0])
        assert np.array_equal(_bits(got[1]), _bits(ref[1])) and np.array_equal(got[2], ref[2])
    assert [key for _, key in w.graphs if key[0] == "FusedServe"] == [keys[0]]


def test_fused_capture_failure_raises(serve_world, monkeypatch):
    """A host sync inside the captured program breaks the capture: the
    request raises, nothing falls back to eager execution, and no graph is
    kept.  (Last of the file: the capture it breaks is the card's.)"""
    from doppelspeller_tpu_torch.ops import serve_fused
    from doppelspeller_tpu_torch.utils.io import TitleSet

    _cfg, _truth, queries = serve_world
    matcher = _serve_matcher(serve_world, "exact")
    real = serve_fused.fused_cascade

    def syncing(*args, **kwargs):
        stats, cand = real(*args, **kwargs)
        stats.sum().item()
        return stats, cand

    monkeypatch.setattr(serve_fused, "fused_cascade", syncing)
    with pytest.raises(RuntimeError):
        matcher.predict(TitleSet.from_titles(queries.titles[:3], config=matcher.cfg))
    assert not [key for _, key in matcher.scorer.workers.graphs if key[0] == "FusedServe"]


# ------------------------------------------------------------------- mesh

@pytest.fixture(scope="module")
def mesh_world():
    """4,096 titles in tiles of 2,048: on one card one index of two tiles, on
    a two-shard mesh one tile a shard, each with real titles (kernel A's
    tile, so its windows are the single card's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh's shards launch the port's kernels")
    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, truth, queries, _ = make_synthetic_world(4096, 512, config=Config(data_path="data"))
    return cfg.with_(title_block=2048), truth, queries


def _one_card_mesh(n=2):
    from doppelspeller_tpu_torch.parallel.sharded import Mesh

    return Mesh((torch.device("cuda", 0),) * n)


@pytest.mark.parametrize("mode", ["exact", "folded"])
def test_single_card_graphs_are_its_op_by_op_run_bit_for_bit(mesh_world, mode):
    """One card run as the JAX package runs one device: retrieval a graph a
    block shape, the fuzzy and model stages a graph a padded run of rows,
    each captured in the second predict that uses it.  Its predicts (the
    first op by op, the second captures, the third replays) and top-100 equal the same Matcher's with
    ``workers.use_graphs = False`` (op by op, the fuzzy stage in its
    dynamic form) bit for bit: scores, positions, ids, stages and
    predictions (bf16 coarse weights on the folded engine)."""
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher
    from test_torch_helpers import MODEL

    cfg, truth, queries = mesh_world
    cfg = cfg.with_(retrieval_mode=mode, cascade_impl="device")
    m = Matcher(cfg, truth, GBTModel.load(str(MODEL)), device="cuda", use_index_checkpoint=False)
    w = m.scorer.workers
    w.use_graphs = False
    v0, p0 = m.scorer.topk(queries)
    before_f = lev.lcs.launches
    r0 = m.predict(queries)
    assert not w.graphs
    assert lev.lcs.launches > before_f                  # fuzzy and the features launch kernel F
    w.use_graphs = True
    results = [m.predict(queries) for _ in range(3)]
    v1, p1 = m.scorer.topk(queries)
    assert {"topk", "FuzzyEngine", "RerankEngine"} <= set(w.captures)
    assert all(sum(w.replays[name]) for name in ("topk", "FuzzyEngine", "RerankEngine"))
    assert np.array_equal(_bits(v0), _bits(v1)) and np.array_equal(p0, p1)
    for r in results:
        assert np.array_equal(r0.match_title_id, r.match_title_id) and np.array_equal(r0.stage, r.stage)
        assert np.array_equal(_bits(r0.prediction), _bits(r.prediction))
    assert all(r0.stage_counts[s] > 0 for s in ("exact", "fuzzy", "model"))
    m.close()


@pytest.mark.parametrize("mode", ["exact", "folded"])
def test_single_card_graphs_hold_each_k(mesh_world, mode):
    """One graphed scorer asked for the top 100, then the top 10, each
    twice (the second call of each replays its graphs): every call equal
    to the same scorer's with ``workers.use_graphs = False`` bit for bit,
    and each k has graphs of its own."""
    from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
    from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index

    cfg, truth, queries = mesh_world
    cfg = cfg.with_(retrieval_mode=mode)
    sc = JaccardScorer(build_truth_index(truth, cfg), cfg, "cuda", truth)
    w = sc.workers
    for k in (100, 100, 10, 10):
        w.use_graphs = False
        v0, p0 = sc.topk(queries, k=k)
        w.use_graphs = True
        v1, p1 = sc.topk(queries, k=k)
        assert v1.shape == (len(queries), k)
        assert np.array_equal(_bits(v0), _bits(v1)) and np.array_equal(p0, p1)
    assert {key[1] for _, key in w.graphs} == {100, 10}
    assert sum(w.replays["topk"]) > 0
    sc.close()


def test_single_card_predict_launches_under_a_thousand(mesh_world):
    """The host's kernel and graph launches for a warm predict on one card
    (torch.profiler's records of the runtime calls; two predicts before
    it, so that every shape is a graph): under 1,000 through the graphs,
    fewer than op by op."""
    from torch.profiler import ProfilerActivity, profile

    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher
    from test_torch_helpers import MODEL

    cfg, truth, queries = mesh_world
    m = Matcher(cfg.with_(cascade_impl="device"), truth, GBTModel.load(str(MODEL)), device="cuda",
                use_index_checkpoint=False)
    launches = {}
    for graphs in (True, False):
        m.scorer.workers.use_graphs = graphs
        for _ in range(2):
            m.predict(queries)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            m.predict(queries)
            torch.cuda.synchronize()
        launches[graphs] = sum(ev.count for ev in prof.key_averages() if ev.key.startswith(
            ("cudaLaunchKernel", "cudaGraphLaunch")))
    assert 0 < launches[True] < 1000 and launches[True] < launches[False], launches
    m.close()


def test_single_card_spans_hold_each_replay_and_wait(mesh_world):
    """A warm predict under the profiler (two before it, so every shape is a
    graph): each stage's graph launches are ``doppel.replay`` spans inside
    it, each fetch a ``.wait`` span, nothing is captured, and a stage's
    replays and waits fit inside it; a single title's one-dispatch replay
    and its stream sync lie inside ``doppel.fused``."""
    from torch.profiler import ProfilerActivity, profile

    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.utils import timing
    from doppelspeller_tpu_torch.utils.io import single_title_set
    from test_torch_helpers import MODEL

    cfg, truth, queries = mesh_world
    m = Matcher(cfg.with_(cascade_impl="device"), truth, GBTModel.load(str(MODEL)), device="cuda",
                use_index_checkpoint=False)
    title = next(t for t, tr in zip(queries.titles, queries.transformed) if tr not in m.reverse)
    for _ in range(2):
        m.predict(queries)
        m.predict(single_title_set(title, cfg), single=True)
    torch.cuda.synchronize()
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        m.predict(queries)
        m.predict(single_title_set(title, cfg), single=True)
    spans = timing.recorded()
    by_id = {s.id: s for s in spans}

    def stage_of(s):
        while s.parent is not None and by_id[s.parent].name != "doppel.predict":
            s = by_id[s.parent]
        return s.name

    assert not [s for s in spans if s.name.startswith("doppel.capture")]
    graphs = {}
    for s in spans:
        if s.name == "doppel.replay":
            graphs.setdefault(stage_of(s), set()).add(s.counts["graph"])
    assert graphs == {"doppel.retrieval": {"topk"}, "doppel.fuzzy": {"FuzzyEngine"},
                      "doppel.model": {"RerankEngine"}, "doppel.fused": {"FusedServe"}}
    for s in spans:
        if s.name in ("doppel.retrieval", "doppel.fuzzy", "doppel.model", "doppel.fused"):
            inner = [c for c in spans if c.parent is not None and stage_of(c) == s.name
                     and c.call == s.call and (c.name == "doppel.replay" or c.name.endswith(".wait"))]
            assert inner and sum(c.duration_ns for c in inner) <= s.duration_ns, s.name
    m.close()


def test_single_card_capture_failure_raises(mesh_world, monkeypatch):
    """A host sync inside a stage's captured program breaks its capture (at
    the second predict): the
    predict raises, naming the shard, nothing runs op by op in its place,
    and no graph of that stage is kept."""
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.parallel.workers import ShardError
    from doppelspeller_tpu_torch.pipeline import Matcher
    from test_torch_helpers import MODEL

    cfg, truth, queries = mesh_world
    m = Matcher(cfg.with_(cascade_impl="device"), truth, GBTModel.load(str(MODEL)), device="cuda",
                use_index_checkpoint=False)
    real = m.fuzzy.decide

    def syncing(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0].sum().item()
        return out

    monkeypatch.setattr(m.fuzzy, "decide", syncing)
    with pytest.raises(ShardError, match="^shard 0 on cuda:0: "):
        for _ in range(2):
            m.predict(queries)
    assert not any(key[0] == "FuzzyEngine" for _, key in m.scorer.workers.graphs)
    m.close()


@pytest.mark.parametrize("score_dtype", ["bfloat16", "float32"])
def test_two_shards_of_one_card_are_the_single_card_bit_for_bit(mesh_world, score_dtype):
    """Exact retrieval (kernel A gathering, once per shard and block) and
    the whole predict: scores, positions, ids, stages and predictions bit
    for bit."""
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher
    from test_torch_helpers import MODEL

    cfg, truth, queries = mesh_world
    cfg = cfg.with_(score_dtype=score_dtype, cascade_impl="device")
    model = GBTModel.load(str(MODEL))
    one = Matcher(cfg, truth, model, device="cuda", use_index_checkpoint=False)
    mesh = Matcher(cfg, truth, model, mesh=_one_card_mesh(), use_index_checkpoint=False)
    assert mesh.scorer.exact is not None and mesh.scorer.tb == one.scorer.exact.tb == 2048
    a0, g0 = jk.score_window_select.launches, jk.score_window_select.gathered
    v2, p2 = mesh.scorer.topk(queries)
    n_blocks = len(queries) // cfg.query_block
    # each shard's first block of a shape is the warm-up run before its
    # graph's capture, every other block a replay: one launch each
    assert jk.score_window_select.launches - a0 == 2 * n_blocks
    assert jk.score_window_select.gathered - g0 == jk.score_window_select.launches - a0
    v1, p1 = one.scorer.topk(queries)
    assert np.array_equal(_bits(v1), _bits(v2)) and np.array_equal(p1, p2)
    # one block a group, and every block op by op: the same bits
    workers = mesh.scorer.workers
    mesh.scorer.cfg = cfg.with_(dispatch_blocks=1)
    workers.use_graphs = False
    v3, p3 = mesh.scorer.topk(queries)
    assert np.array_equal(_bits(v1), _bits(v3)) and np.array_equal(p1, p3)
    r1, r3 = one.predict(queries), mesh.predict(queries)          # the mesh op by op
    mesh.scorer.cfg, workers.use_graphs = cfg, True
    r2 = [mesh.predict(queries) for _ in range(2)]     # the second captures the fuzzy and model graphs
    assert {"FuzzyEngine", "RerankEngine"} <= set(workers.captures)
    for r in r2 + [r3]:
        assert np.array_equal(r1.match_title_id, r.match_title_id) and np.array_equal(r1.stage, r.stage)
        assert np.array_equal(_bits(r1.prediction), _bits(r.prediction))
    mesh.close()


@pytest.mark.parametrize("mode", ["exact", "folded"])
def test_mesh_graphs_are_captured_once_per_shard_and_shape_then_replayed(mesh_world, mode):
    """Each shard runs its block shapes op by op in the first call, captures
    each at its first block of the second (that block the warm-up run's
    result) and replays it afterwards; the replays give the op-by-op run's
    candidates (exact: bit for bit; folded, whose coarse weights add by
    atomics: each a superset of the single card's, score by score)."""
    from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
    from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
    from doppelspeller_tpu_torch.parallel.sharded import ShardedJaccardScorer

    cfg, truth, queries = mesh_world
    cfg = cfg.with_(retrieval_mode=mode, dispatch_blocks=2)
    index = build_truth_index(truth, cfg)
    sc = ShardedJaccardScorer(index, _one_card_mesh(), cfg, truth=truth)
    n_blocks = len(queries) // cfg.query_block
    shapes = Counter(shape for shape, _ in sc._blocks(queries, None)[1])
    assert sum(shapes.values()) == n_blocks
    k = cfg.top_n_predicting
    w = sc.workers
    a0 = jk.score_window_select.launches
    first = sc.topk(queries)
    assert not w.graphs and jk.score_window_select.launches - a0 == 2 * n_blocks
    second = sc.topk(queries)
    keys = {("topk", k) + tuple(s) for s in shapes}
    assert set(w.graphs) == {(i, key) for i in range(2) for key in keys}
    assert w.captures["topk"] == [len(keys)] * 2
    assert w.replays["topk"] == [n_blocks - len(keys)] * 2
    assert jk.score_window_select.launches - a0 == 4 * n_blocks
    third = sc.topk(queries)
    assert w.captures["topk"] == [len(keys)] * 2 and w.replays["topk"] == [2 * n_blocks - len(keys)] * 2
    w.use_graphs = False
    eager = sc.topk(queries)
    assert w.replays["topk"] == [2 * n_blocks - len(keys)] * 2
    if mode == "exact":
        for got in (first, second, third):
            assert np.array_equal(_bits(got[0]), _bits(eager[0])) and np.array_equal(got[1], eager[1])
    else:
        v1, _ = JaccardScorer(index, cfg, "cuda", truth).topk(queries)
        assert all((got[0] >= v1).all() for got in (first, second, third, eager))
    sc.close()


def test_two_shards_of_one_card_run_on_two_streams(mesh_world, tmp_path):
    """``Mesh((cuda:0, cuda:0))``: one worker thread for the card, a stream
    for each shard, neither the caller's; kernel A's replays land on two
    streams (the profiler's trace)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
    from doppelspeller_tpu_torch.parallel.sharded import ShardedJaccardScorer

    cfg, truth, queries = mesh_world
    sc = ShardedJaccardScorer(build_truth_index(truth, cfg), _one_card_mesh(), cfg)
    s0, s1 = sc.workers.streams
    ids = {s0.stream_id, s1.stream_id, torch.cuda.current_stream().stream_id}
    assert len(ids) == 3
    sc.topk(queries)                                     # captures
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sc.topk(queries)
        torch.cuda.synchronize()
    assert len(sc.workers._threads) == 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    streams = {e["args"]["stream"] for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel" and "score_window" in e.get("name", "")}
    assert len(streams) == 2
    sc.close()


def test_folded_mesh_dominates_the_single_card(mesh_world):
    """Each shard rescores its own coarse top-k', a superset of the single
    card's coarse candidates: every row's i-th score is at least the single
    card's."""
    from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
    from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
    from doppelspeller_tpu_torch.parallel.sharded import ShardedJaccardScorer

    cfg, truth, queries = mesh_world
    cfg = cfg.with_(retrieval_mode="folded")
    index = build_truth_index(truth, cfg)
    a0 = jk.score_window_select.launches
    mesh = ShardedJaccardScorer(index, _one_card_mesh(), cfg, truth=truth)
    v2, _ = mesh.topk(queries)
    assert jk.score_window_select.launches - a0 == 2 * len(queries) // cfg.query_block
    v1, _ = JaccardScorer(index, cfg, "cuda", truth).topk(queries)
    assert (v2 >= v1).all()


def test_data_parallel_train_gbt_on_the_card_is_one_card_bit_for_bit(cuda):
    from doppelspeller_tpu_torch.models import gbt

    X, y = _train_data(6001, 7)
    Xe, ye = _train_data(999, 8)
    params = gbt.GBTParams(num_boost_round=30, early_stopping_rounds=30)
    a = gbt.train_gbt(X, y, Xe, ye, params, verbose_every=0, device=cuda)
    b = gbt.train_gbt(X, y, Xe, ye, params, verbose_every=0, mesh=_one_card_mesh(3))
    assert a.num_trees == b.num_trees == 30 and a.history == b.history
    for name in ("feat", "split_bin", "missing_left", "value", "is_leaf", "threshold"):
        assert getattr(a, name).tobytes() == getattr(b, name).tobytes(), name


def test_mesh_of_two_cards_launches_each_shard_on_its_card(mesh_world):
    """With cuda:0 current, a shard on cuda:1 launches there (the launch
    makes its tensors' card current): kernel A on cuda:1 equals its plain
    version, and a two-card mesh is the single card, bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.parallel.sharded import make_mesh
    from doppelspeller_tpu_torch.pipeline import Matcher
    from test_torch_helpers import MODEL

    torch.cuda.set_device(0)
    d1 = torch.device("cuda", 1)
    rows, w, sums, maxint = _a_inputs(11, 64, 512, 2, 8192, 8000, d1)
    got = jk.score_window_select(rows, w, sums, maxint, 8000, tb=2048, W=16, folds=2,
                                 score_dtype="float32")
    ref = jk.score_window_select_plain(rows, w, sums, maxint, 8000, tb=2048, W=16, folds=2)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
    cfg, truth, queries = mesh_world
    model = GBTModel.load(str(MODEL))
    r1 = Matcher(cfg, truth, model, device="cuda", use_index_checkpoint=False).predict(queries)
    mesh = Matcher(cfg, truth, model, mesh=make_mesh(2), use_index_checkpoint=False)
    assert mesh._fuzzy_copies[d1].t_enc.device == d1
    r2 = mesh.predict(queries)
    assert np.array_equal(r1.match_title_id, r2.match_title_id)
    assert np.array_equal(_bits(r1.prediction), _bits(r2.prediction))


def test_four_card_mesh_is_the_single_card_bit_for_bit(mesh_world):
    """``make_mesh(4)``: a worker thread for each card, every shard's
    graphs replayed on its card, and the predictions the single card's."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.parallel.sharded import make_mesh
    from doppelspeller_tpu_torch.pipeline import Matcher
    from test_torch_helpers import MODEL

    cfg, truth, queries = mesh_world
    model = GBTModel.load(str(MODEL))
    one = Matcher(cfg, truth, model, device="cuda", use_index_checkpoint=False)
    mesh = Matcher(cfg, truth, model, mesh=make_mesh(4), use_index_checkpoint=False)
    v1, p1 = one.scorer.topk(queries)
    mesh.predict(queries)
    v2, p2 = mesh.scorer.topk(queries)
    assert np.array_equal(_bits(v1), _bits(v2)) and np.array_equal(p1, p2)
    r1, r2 = one.predict(queries), mesh.predict(queries)
    assert np.array_equal(r1.match_title_id, r2.match_title_id) and np.array_equal(r1.stage, r2.stage)
    assert np.array_equal(_bits(r1.prediction), _bits(r2.prediction))
    w = mesh.scorer.workers
    assert len(w._threads) == 4 and all(n > 0 for n in w.replays["topk"])
    assert {g.static_in[0].device for g in w.graphs.values()} == set(mesh.mesh.devices)
    mesh.close()


def _same_buffers(a, b):
    """Every buffer of two engines equal bit for bit."""
    bufs_a, bufs_b = dict(a.named_buffers()), dict(b.named_buffers())
    assert bufs_a.keys() == bufs_b.keys()
    for name, x in bufs_a.items():
        y = bufs_b[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)), name


@pytest.mark.parametrize("mode", ["exact", "folded"])
def test_device_build_on_the_card_is_the_host_build_bit_for_bit(mesh_world, mode):
    """The index built on the card from the encodings, its engine's
    matrices, and each shard of a mesh built on the card equal the host
    build's, and so does their top-k."""
    from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
    from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
    from doppelspeller_tpu_torch.parallel.sharded import ShardedJaccardScorer, build_sharded_index

    cfg, truth, queries = mesh_world
    cfg = cfg.with_(retrieval_mode=mode)
    host = build_truth_index(truth, cfg.with_(index_build_impl="host"))
    dev = build_truth_index(truth, cfg, "cuda")
    assert (host.built_on, dev.built_on) == ("host", "device")
    assert build_truth_index(truth, cfg).built_on == "device"      # no device: the card
    for f in ("df", "idf", "sums", "trigrams", "title_ids"):
        assert getattr(dev, f).tobytes() == getattr(host, f).tobytes(), f
    for f in ("num_titles", "padded_titles", "max_idf", "content_hash"):
        assert getattr(dev, f) == getattr(host, f), f
    a, b = JaccardScorer(dev, cfg, "cuda", truth), JaccardScorer(host, cfg, "cuda", truth)
    _same_buffers(*((s.exact, s.folded)[mode == "folded"] for s in (a, b)))
    (va, pa), (vb, pb) = a.topk(queries), b.topk(queries)
    assert np.array_equal(_bits(va), _bits(vb)) and np.array_equal(pa, pb)
    mesh = _one_card_mesh()
    built = build_sharded_index(truth, mesh, cfg)
    for f in ("df", "idf", "sums", "trigrams", "title_ids"):
        assert getattr(built.index, f).tobytes() == getattr(host, f).tobytes(), f
    before = ShardedJaccardScorer(host, mesh, cfg, truth=truth)
    for x, y in zip(*((s.exact or s.folded) for s in (built, before))):
        _same_buffers(x, y)
    (vm, pm), (vh, ph) = built.topk(queries), before.topk(queries)
    assert np.array_equal(_bits(vm), _bits(vh)) and np.array_equal(pm, ph)


def test_matcher_on_the_card_takes_the_device_build_under_auto(mesh_world):
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher
    from test_torch_helpers import MODEL

    cfg, truth, queries = mesh_world
    model = GBTModel.load(str(MODEL))
    assert cfg.index_build_impl == "auto"
    # the device build keeps nothing more on the card than the host build
    # (built second, so no first-use allocation counts against it)
    a0 = torch.cuda.memory_allocated()
    host = Matcher(cfg.with_(index_build_impl="host"), truth, model, device="cuda",
                   use_index_checkpoint=False)
    a1 = torch.cuda.memory_allocated()
    dev = Matcher(cfg, truth, model, device="cuda", use_index_checkpoint=False)
    a2 = torch.cuda.memory_allocated()
    assert (dev.index.built_on, host.index.built_on) == ("device", "host")
    assert a2 - a1 <= a1 - a0
    r1, r2 = dev.predict(queries), host.predict(queries)
    assert np.array_equal(r1.match_title_id, r2.match_title_id) and np.array_equal(r1.stage, r2.stage)
    assert np.array_equal(_bits(r1.prediction), _bits(r2.prediction))
