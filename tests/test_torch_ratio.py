"""PyTorch port: the LCS-ratio host wrappers (``batched_ratio``,
``ratio_rounded``) and ``WordCounts.for_titles`` equal the JAX package's on
the same numpy inputs.  Torch runs on one thread (small operations)."""

import numpy as np
import pytest
import torch

from doppelspeller_tpu.config import Config as JConfig
from doppelspeller_tpu.models.trainer import WordCounts as JWordCounts
from doppelspeller_tpu.ops.levenshtein import batched_ratio as j_batched_ratio
from doppelspeller_tpu.ops.levenshtein import ratio_rounded as j_ratio_rounded
from doppelspeller_tpu.utils.io import TitleSet as JTitleSet
from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.models.trainer import WordCounts
from doppelspeller_tpu_torch.ops.levenshtein import batched_ratio, ratio_rounded
from doppelspeller_tpu_torch.utils.io import TitleSet


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(seed, n, width, lengths, alphabet):
    """n pairs of u8 encodings (n, width), each length drawn from
    ``lengths`` (a list of (lo, hi) ranges, one picked per pair), zero past
    its length."""
    rng = np.random.default_rng(seed)
    spans = np.asarray(lengths)

    def side():
        pick = spans[rng.integers(0, len(spans), n)]
        ln = rng.integers(pick[:, 0], pick[:, 1] + 1).astype(np.int32)
        enc = rng.integers(1, alphabet + 1, (n, width)).astype(np.uint8)
        enc[np.arange(width)[None, :] >= ln[:, None]] = 0
        return enc, ln

    (a, la), (b, lb) = side(), side()
    return a, la, b, lb


# lengths in every bucket of the default (32, 64, 128, 256), both ends
# included, and empty titles
_EVERY_BUCKET = [(0, 0), (1, 32), (33, 64), (65, 128), (129, 255), (256, 256)]


@pytest.mark.parametrize("width,lengths,alphabet", [
    (256, _EVERY_BUCKET, 3),
    (256, [(240, 256)], 26),            # the widest bucket alone, 256 included
    (100, [(0, 3), (20, 40), (90, 100)], 2),   # width 100: buckets 32, 64 and 100
])
def test_batched_ratio_equals_jax(width, lengths, alphabet):
    a, la, b, lb = _pairs(width + alphabet, 300, width, lengths, alphabet)
    want = j_batched_ratio(a, la, b, lb, JConfig())
    got = batched_ratio(a, la, b, lb, Config(), device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    both_empty = (la == 0) & (lb == 0)
    if both_empty.any():
        assert (got[both_empty] == 100.0).all()


def test_ratio_rounded_equals_jax_at_half_ties():
    """Banker's rounding.  Length sums of 16, 80, 160 and 400 put many
    ratios exactly on .5 in every bucket (a 2-letter alphabet)."""
    rng = np.random.default_rng(4)
    sizes = np.array([(8, 8), (5, 11), (40, 40), (80, 80), (200, 200), (256, 144)] * 60)
    la, lb = sizes[:, 0].astype(np.int32), sizes[:, 1].astype(np.int32)
    a = rng.integers(1, 3, (len(sizes), 256)).astype(np.uint8)
    b = rng.integers(1, 3, (len(sizes), 256)).astype(np.uint8)
    a[np.arange(256)[None, :] >= la[:, None]] = 0
    b[np.arange(256)[None, :] >= lb[:, None]] = 0
    want = j_ratio_rounded(a, la, b, lb, JConfig())
    got = ratio_rounded(a, la, b, lb, Config(), device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    half = batched_ratio(a, la, b, lb, Config(), device="cpu") % 1 == 0.5
    assert half.sum() > 50 and len(np.unique(la[half] + lb[half])) >= 3


def test_word_counts_for_titles_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    words = ["".join(rng.choice(list("abcde"), rng.integers(1, 6))) for _ in range(40)]
    titles = [" ".join(rng.choice(words, rng.integers(1, 20))) for _ in range(300)]
    ids = np.arange(300, dtype=np.int64) * 3 + 7
    jtruth = JTitleSet.from_titles(titles, ids=ids, config=JConfig(data_path=str(tmp_path)))
    truth = TitleSet.from_titles(titles, ids=ids, config=Config(data_path=str(tmp_path)))
    queries = titles[:50] + [" ".join(rng.choice(words, 18)) for _ in range(50)] + ["", "zz qq"]
    want = JWordCounts(jtruth).for_titles(queries)
    wc = WordCounts(truth)
    got = wc.for_titles(queries)
    assert got.dtype == np.uint32 and got.shape == (len(queries), 15)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(wc.matrix(queries), got)
    assert (got[:50, 0] > 0).all() and (got[-2:] == 0).all()
