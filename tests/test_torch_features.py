"""PyTorch port, model-stage features: kernel B's plain version against the
Pallas kernel in interpret mode (exactly, at random shapes and at the
edges), the CUDA kernel's LCS step against the reference's, and all 66
features against the JAX ``_features_kernel``."""

import random
import string

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doppelspeller_tpu.ops.features import _features_kernel
from doppelspeller_tpu.ops.features_pallas import window_best_pallas
from doppelspeller_tpu_torch.ops import features as F
from doppelspeller_tpu_torch.ops.features_kernels import window_best, window_best_plain
from doppelspeller_tpu_torch.utils import text as T


def _random_b_inputs(seed, B, TL, WL):
    rng = np.random.RandomState(seed)
    q_wo = rng.randint(2, 8, (B, TL)).astype(np.uint8)      # small alphabet: many matches
    q_wo_len = rng.randint(0, TL + 1, B).astype(np.int32)
    q_wo[np.arange(TL)[None, :] >= q_wo_len[:, None]] = 0
    wlen = rng.randint(0, WL + 1, (B, 15)).astype(np.int32)
    wlen[:, 6:] = 0
    wchars = (rng.randint(2, 8, (B, 15, WL)) * (np.arange(WL) < wlen[:, :, None])).astype(np.uint8)
    return wchars, wlen, q_wo, q_wo_len


@pytest.mark.parametrize("TL,WL", [(32, 8), (32, 32), (64, 16), (64, 32)])
def test_kernel_b_plain_matches_pallas_interpret(TL, WL):
    args = _random_b_inputs(TL + WL, 37, TL, WL)
    r_j, p_j = window_best_pallas(*(jnp.asarray(a) for a in args), interpret=True)
    r_p, p_p = window_best(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(np.asarray(r_j), r_p.numpy())
    np.testing.assert_array_equal(np.asarray(p_j), p_p.numpy())
    assert (r_p.numpy() == -1).any() and (r_p.numpy() > 0).any()


def _edge_b_inputs(TL, WL):
    """One pair per edge: qwol 0, 1 and TL; every slot empty; all 15 slots
    full, of lengths 1..WL; words of length WL (32: the whole u32);
    windows that all tie (one repeated character)."""
    rng = np.random.RandomState(TL * WL)
    B = 8
    q_wo = rng.randint(2, 6, (B, TL)).astype(np.uint8)
    q_wo_len = np.array([0, 1, TL, TL, TL, 7, TL - 1, TL // 2], np.int32)
    wlen = rng.randint(1, WL + 1, (B, 15)).astype(np.int32)
    wlen[:, 5:] = 0
    wlen[3] = 0                                              # no word at all
    wlen[4] = 1 + np.arange(15) % WL                         # every slot full
    wlen[2, :3] = [WL, 1, WL]
    wlen[5, :2] = [WL, 1]
    chars = rng.randint(2, 6, (B, 15, WL))
    q_wo[6], chars[6], wlen[6, :3] = 3, 3, [1, min(4, WL), min(WL, TL - 1)]
    q_wo[np.arange(TL)[None, :] >= q_wo_len[:, None]] = 0
    chars = (chars * (np.arange(WL) < wlen[:, :, None])).astype(np.uint8)
    return chars, wlen, q_wo, q_wo_len


@pytest.mark.parametrize("TL,WL", [(32, 32), (64, 32), (64, 16), (16, 8)])
def test_kernel_b_plain_matches_pallas_interpret_at_the_edges(TL, WL):
    """Exact equality, ratios and positions."""
    args = _edge_b_inputs(TL, WL)
    r_j, p_j = window_best_pallas(*(jnp.asarray(a) for a in args), interpret=True)
    r_p, p_p = window_best_plain(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(np.asarray(r_j), r_p.numpy())
    np.testing.assert_array_equal(np.asarray(p_j), p_p.numpy())
    r, p = r_p.numpy(), p_p.numpy()
    assert (r[0] == -1).all() and (p[0] == 0).all()          # an empty query
    assert (r[3] == -1).all() and (p[3] == 0).all()          # no word
    assert (r[4] >= 0).all()                                 # 15 full slots
    assert (r[6, :3] == 100).all() and (p[6, :3] == 0).all() # ties keep the first window


@pytest.mark.parametrize("seed", [0, 1])
def test_three_operation_lcs_step_equals_the_reference_step(seed):
    """The CUDA kernel's step, U = V & M; V = (V + U) | (V & ~M) with the
    word mask applied once at the end, against the reference's
    V = ((V + U) | (V − U)) & mask on every step: equal on random 32-bit
    masks, match words and word lengths 1..32, step after step."""
    g = torch.Generator().manual_seed(seed)
    n, steps = 4096, 40
    wlen = torch.randint(1, 33, (n,), generator=g)
    mask = (torch.ones(n, dtype=torch.int64) << wlen) - 1
    v_ref = mask.clone()
    v_new = mask.clone()
    for _ in range(steps):
        # the kernel's table may hold bits past the word; the reference's never act there
        m = torch.randint(0, 1 << 32, (n,), generator=g) & torch.randint(0, 1 << 32, (n,), generator=g)
        u = v_ref & m
        v_ref = ((v_ref + u) | (v_ref - u)) & mask
        # u32 arithmetic held in int64: the sum wraps at 32 bits
        v_new = ((v_new + (v_new & m)) | (v_new & ~m)) & 0xFFFFFFFF
        assert torch.equal(v_new & mask, v_ref)
        assert int(v_new.max()) < 1 << 32 and int(v_new.min()) >= 0
    assert (v_ref != mask).any()


def _pairs(seed, n, long_word=False):
    rng = random.Random(seed)

    def word(lo, hi):
        return "".join(rng.choice(string.ascii_lowercase[:8]) for _ in range(rng.randint(lo, hi)))

    out = []
    for i in range(n):
        cand = " ".join(word(2, 9) for _ in range(rng.randint(1, 5)))
        if long_word and i % 3 == 0:
            cand = word(2, 5) + " " + word(33, 40)
        q = list(cand.replace(" ", "") if i % 4 == 0 else cand)
        for _ in range(rng.randint(0, 3)):
            j = rng.randrange(len(q))
            q[j] = rng.choice(string.ascii_lowercase[:8])
        out.append((T.transform_title("".join(q)), T.transform_title(cand)))
    out.append(("a", "zzz"))                      # nothing in common
    out.append(("aa bb", "aa bb"))
    return out


def _feature_inputs(pairs, TL, WL):
    q = [p[0] for p in pairs]
    t = [p[1] for p in pairs]
    q_enc = T.encode_titles(q)
    t_enc = T.encode_titles(t)
    q_len = np.array([len(s) for s in q], np.int32)
    t_len = np.array([len(s) for s in t], np.int32)
    start, wlen, nwords = F.split_words_host(t_enc, t_len)
    q_wo, q_wo_len = F.remove_spaces_host(q_enc, q_len)
    wchars = F.gather_word_chars(t_enc, start, wlen, WL)
    counts = np.random.default_rng(len(pairs)).integers(0, 50, wlen.shape).astype(np.float32)
    return (q_enc[:, :TL], q_len, t_enc[:, :TL], np.maximum(t_len, 1), wchars, wlen,
            np.maximum(nwords, 1), q_wo[:, :TL], np.maximum(q_wo_len, 1), counts)


@pytest.mark.parametrize("TL,WL,long_word,impl", [
    (64, 16, False, "xla"),
    (64, 32, False, "pallas_interpret"),
    (64, 48, True, "xla"),                        # words over 32 chars: plain window DP
])
def test_66_features_match_jax(TL, WL, long_word, impl):
    pairs = _pairs(TL + WL, 40 if long_word else 60, long_word)
    args = _feature_inputs(pairs, TL, WL)
    n_truth = 5000.0
    ref = np.asarray(_features_kernel(*(jnp.asarray(a) for a in args), jnp.float32(n_truth),
                                      window_impl=impl))
    got = F.features_kernel(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), n_truth).numpy()
    assert got.shape == ref.shape == (len(pairs), 66)
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))
    np.testing.assert_array_equal(ref[:, :36], got[:, :36])          # integer-valued + NaN
    np.testing.assert_allclose(ref[:, 36:], got[:, 36:], rtol=1e-6, equal_nan=True)
    if long_word:
        assert (args[5].max(axis=1) > 32).any()
    assert (ref[:, 5] > 0).any() and (ref[:, 4] < 100).any()


def test_host_prep_equals_jax():
    from doppelspeller_tpu.ops import features as JF

    pairs = _pairs(5, 40, True)
    enc = T.encode_titles([p[1] for p in pairs])
    lens = np.array([len(p[1]) for p in pairs], np.int32)
    for a, b in zip(JF.split_words_host(enc, lens), F.split_words_host(enc, lens)):
        np.testing.assert_array_equal(a, b)
    s, w, _ = F.split_words_host(enc, lens)
    np.testing.assert_array_equal(JF.gather_word_chars(enc, s, w, 48), F.gather_word_chars(enc, s, w, 48))
    for a, b in zip(JF.remove_spaces_host(enc, lens), F.remove_spaces_host(enc, lens)):
        np.testing.assert_array_equal(a, b)
