"""PyTorch port: the bit-parallel LCS (int64 lanes, explicit carry and
borrow across 32-bit words) equals the JAX ``lcs_kernel`` exactly, both as
``lcs_plain`` and through ``lcs``, whose CPU route it is (kernel F, the
CUDA route, is held against ``lcs_plain`` in ``test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doppelspeller_tpu.ops.levenshtein import lcs_kernel
from doppelspeller_tpu_torch import _build
from doppelspeller_tpu_torch.ops import levenshtein
from doppelspeller_tpu_torch.ops.levenshtein import lcs, lcs_plain, popcount32, rounded_ratio


def _pairs(rng, B, La, Lb, lo, hi, alphabet):
    a = rng.integers(1, alphabet + 1, (B, La)).astype(np.uint8)
    b = rng.integers(1, alphabet + 1, (B, Lb)).astype(np.uint8)
    la = rng.integers(lo, min(hi, La) + 1, B).astype(np.int32)
    lb = rng.integers(lo, min(hi, Lb) + 1, B).astype(np.int32)
    a[np.arange(La)[None, :] >= la[:, None]] = 0
    b[np.arange(Lb)[None, :] >= lb[:, None]] = 0
    return a, la, b, lb


CASES = [
    (32, 32, 0, 32, 4),        # one word, small alphabet (long LCS)
    (64, 64, 33, 64, 3),       # two words: carries across the boundary
    (128, 96, 33, 128, 6),
    (256, 256, 33, 255, 5),    # eight words, lengths 33-255
    (40, 200, 1, 200, 37),     # ragged widths, full alphabet
]


def _check_equals_jax(fn, La, Lb, lo, hi, alphabet):
    rng = np.random.default_rng(La * 7 + Lb)
    a, la, b, lb = _pairs(rng, 48, La, Lb, lo, hi, alphabet)
    ref = np.asarray(lcs_kernel(jnp.asarray(a), jnp.asarray(la), jnp.asarray(b), jnp.asarray(lb)))
    got = fn(torch.from_numpy(a), torch.from_numpy(la), torch.from_numpy(b), torch.from_numpy(lb))
    np.testing.assert_array_equal(ref, got.numpy())


def _check_lengths_past_the_width(fn):
    rng = np.random.default_rng(2)
    a, la, b, lb = _pairs(rng, 32, 40, 40, 10, 40, 5)
    la = la + 20
    ref = np.asarray(lcs_kernel(jnp.asarray(a), jnp.asarray(la), jnp.asarray(b), jnp.asarray(lb)))
    got = fn(torch.from_numpy(a), torch.from_numpy(la), torch.from_numpy(b), torch.from_numpy(lb))
    np.testing.assert_array_equal(ref, got.numpy())


@pytest.mark.parametrize("La,Lb,lo,hi,alphabet", CASES)
def test_lcs_equals_jax(La, Lb, lo, hi, alphabet):
    _check_equals_jax(lcs, La, Lb, lo, hi, alphabet)


@pytest.mark.parametrize("La,Lb,lo,hi,alphabet", CASES)
def test_lcs_plain_equals_jax(La, Lb, lo, hi, alphabet):
    _check_equals_jax(lcs_plain, La, Lb, lo, hi, alphabet)


def test_lcs_with_lengths_past_the_width():
    """A length past the array width (a truncated title) is read as the
    padded width, exactly as the reference does."""
    _check_lengths_past_the_width(lcs)


def test_lcs_plain_with_lengths_past_the_width():
    _check_lengths_past_the_width(lcs_plain)


def test_lcs_on_cpu_tensors_never_loads_the_kernels(monkeypatch):
    """CPU tensors take ``lcs_plain``: the kernels' library is never asked
    for (there is no nvcc here) and no launch is counted."""
    def no_library():
        raise AssertionError("lcs on CPU tensors asked for the CUDA library")

    monkeypatch.setattr(_build, "lib", no_library)
    rng = np.random.default_rng(5)
    a, la, b, lb = _pairs(rng, 20, 64, 64, 0, 64, 4)
    before = lcs.launches
    args = [torch.from_numpy(x) for x in (a, la.astype(np.int64), b, lb)]
    assert torch.equal(lcs(*args), lcs_plain(*args))
    assert lcs.launches == before


def test_lcs_refuses_a_device_that_is_neither_cpu_nor_cuda():
    """The dispatcher knows two routes; any other device raises instead of
    falling back."""
    a = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    n = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="kernel F"):
        levenshtein.lcs(a, n, a, n)


def test_rounded_ratio_equals_jax_rounding():
    """Banker's rounding of 200·lcs/(|a|+|b|), as the JAX fuzzy stage rounds
    (many ratios land exactly on .5 with a 2-letter alphabet)."""
    rng = np.random.default_rng(4)
    a, la, b, lb = _pairs(rng, 400, 16, 16, 1, 16, 2)
    lcs_j = lcs_kernel(jnp.asarray(a), jnp.asarray(la), jnp.asarray(b), jnp.asarray(lb))
    total = jnp.maximum(jnp.asarray(la) + jnp.asarray(lb), 1).astype(jnp.float32)
    ref = np.asarray(jnp.round(200.0 * lcs_j.astype(jnp.float32) / total).astype(jnp.int32))
    got = rounded_ratio(torch.from_numpy(a), torch.from_numpy(la), torch.from_numpy(b), torch.from_numpy(lb))
    np.testing.assert_array_equal(ref, got.numpy())
    frac = (200.0 * np.asarray(lcs_j) / np.maximum(la + lb, 1)) % 1
    assert (frac == 0.5).any()


def test_popcount32():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 1000, dtype=np.int64)
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(popcount32(torch.from_numpy(x)).numpy(), want)
