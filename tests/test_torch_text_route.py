"""PyTorch port, host text: the flat route (one byte buffer, one table, masks
over the flat characters) held equal to the per-title loops it replaced, in
all five arrays a ``TitleSet`` derives from its titles: ``transformed``,
``encoded``, ``lengths``, ``encoded_wo`` and ``encoded_token_sorted``.

Each case runs twice: with the flat route forced at every batch size
(``FLAT_MIN_TITLES`` 0), and with the size rule as shipped.  No torch
operation runs here but construction's, in the last test."""

import contextlib
import pathlib

import numpy as np
import pytest

from doppelspeller_tpu_torch import synthetic
from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils import timing
from doppelspeller_tpu_torch.utils.io import TitleSet

MODEL = pathlib.Path(__file__).resolve().parents[1] / "doppelspeller_tpu_torch" / "assets" / "bench_model_r60.npz"
WHITESPACE = "\t\n\x0b\x0c\r\x1c\x1d\x1e\x1f "
FILLER = ["filler title %d" % i for i in range(12)]   # lifts a case past the size rule


def _cut_at_space(n: int, cut: int = T.MAX_CHARACTERS) -> str:
    """An ``n``-character title whose character at ``cut - 1`` is a space."""
    head = ("ab " * cut)[: cut - 1] + " "
    return (head + "x" * n)[:n]


CASES = {
    "empty": [""],
    "one_char": ["a"],
    "two_chars": ["Z9"],
    "one_two_mixed": ["a", "", "bc", "-", "x-"],
    "punctuation": ["!@#$%^&*()_+={}[]|\\:;\"'<>,.?/~`", ".", "&&"],
    "dash_runs": ["a--b", "---", "-a-", "x - - y", "--lead", "trail--"],
    "upper_case": ["ABC Def", "HELLO-WORLD", "MiXeD CaSe 42"],
    "digits_and_letters": ["b1 a 1a 0 ab a", "z 9 a 10 1 b2 b10", "2b 2a 10 1"],
    "duplicate_words": ["ab ab ab", "x y x y", "co co 1 1"],
    "length_254": [_cut_at_space(254)],
    "length_255": [_cut_at_space(255)],
    "length_256": [_cut_at_space(256)],
    "length_300": [_cut_at_space(300), "q" * 300, "w " * 150],
    "mixed_ascii_unicode": ["Zoë Café", "plain title", "ÅÄÖ åäö", "", "naïve-co 7", "last one"],
    "one_title": ["Coolblue Holdings B.V."],
}
for _ch in WHITESPACE:
    CASES[f"ws_{ord(_ch):02x}"] = [f"{_ch}lead", f"in{_ch}side", f"trail{_ch}",
                                   f"{_ch}{_ch}a{_ch}{_ch}b{_ch}{_ch}", _ch, f"x{_ch}-{_ch}y"]


@pytest.fixture(params=["flat", "size_rule"])
def route(request, monkeypatch):
    if request.param == "flat":
        monkeypatch.setattr(T, "FLAT_MIN_TITLES", 0)
    return request.param


def _oracle(titles, max_characters=T.MAX_CHARACTERS, n_grams=T.N_GRAMS):
    transformed = T.transform_titles_plain(titles, max_characters, n_grams)
    return (transformed, T.encode_titles_plain(transformed, max_characters),
            np.array([min(len(t), max_characters) for t in transformed], dtype=np.int32),
            T.spaceless_codes_plain(transformed, max_characters),
            T.token_sorted_codes_plain(transformed, max_characters))


def _assert_equal(ts: TitleSet, oracle) -> None:
    transformed, encoded, lengths, wo, tsort = oracle
    assert ts.transformed == transformed
    for got, want in [(ts.encoded, encoded), (ts.lengths, lengths), *zip(ts.encoded_wo, wo),
                      *zip(ts.encoded_token_sorted, tsort)]:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_route_equals_per_title(case, route):
    titles = CASES[case]
    _assert_equal(TitleSet.from_titles(titles), _oracle(titles))
    # the same titles among others: their rows keep their places
    batch = FILLER[:3] + titles + FILLER[3:]
    _assert_equal(TitleSet.from_titles(batch), _oracle(batch))


@pytest.mark.parametrize("max_characters,n_grams", [(10, 3), (5, 3), (2, 3), (8, 4)])
def test_flat_route_other_widths(max_characters, n_grams, route):
    titles = [t for case in CASES.values() for t in case]
    transformed, encoded, lengths, _ = T.transform_encode_titles(titles, max_characters, n_grams)
    ts = TitleSet(titles=titles, transformed=transformed, ids=np.arange(len(titles)),
                  encoded=encoded, lengths=lengths)
    _assert_equal(ts, _oracle(titles, max_characters, n_grams))


@pytest.mark.parametrize("which", ["truth", "queries"])
def test_flat_route_synthetic_world(which, route):
    _, truth, queries, _ = synthetic.make_synthetic_world(3000, 600)
    ts = truth if which == "truth" else queries
    _assert_equal(ts, _oracle(ts.titles))


def test_constructed_titleset_derives_its_encodings(route):
    """A slice built by the constructor, as a mesh shard's truth is: the lazy
    encodings come from its own transformed, encoded and lengths."""
    _, truth, _, _ = synthetic.make_synthetic_world(3000, 10)
    lo, hi = 700, 1900
    part = TitleSet(titles=truth.titles[lo:hi], transformed=truth.transformed[lo:hi],
                    ids=truth.ids[lo:hi], encoded=truth.encoded[lo:hi], lengths=truth.lengths[lo:hi])
    _assert_equal(part, _oracle(truth.titles[lo:hi]))


def test_mixed_batch_keeps_row_order_and_counts_per_title(route):
    titles = FILLER[:5] + ["Zoë Café"] + FILLER[5:] + ["ÅÄÖ", "end title"]
    transformed, encoded, lengths, per_title = T.transform_encode_titles(titles)
    assert transformed[5] == "zoe cafe" and transformed[-2] == "aao"
    assert transformed == T.transform_titles_plain(titles)
    np.testing.assert_array_equal(encoded, T.encode_titles_plain(transformed))
    np.testing.assert_array_equal(lengths, [len(t) for t in transformed])
    assert per_title == 2


def test_encode_span_counts_per_title(monkeypatch):
    """``doppel.encode`` and the lazy spans count the titles that took the
    per-title route: the non-ASCII ones, or all of a batch under the size rule."""
    seen = []

    @contextlib.contextmanager
    def span(name, **counts):
        class Sp:
            def set(self, **more):
                counts.update(more)
        yield Sp()
        seen.append((name, counts))

    monkeypatch.setattr(timing, "span", span)
    big = FILLER + ["Zoë Café", "plain"]
    ts = TitleSet.from_titles(big)
    ts.encoded_wo, ts.encoded_token_sorted
    one = TitleSet.from_titles(["just one"])
    one.encoded_wo, one.encoded_token_sorted
    assert seen == [
        ("doppel.encode", {"titles": len(big), "per_title": 1}),
        ("doppel.encode.wo", {"titles": len(big), "per_title": 0}),
        ("doppel.encode.token_sort", {"titles": len(big), "per_title": 0}),
        ("doppel.encode", {"titles": 1, "per_title": 1}),
        ("doppel.encode.wo", {"titles": 1, "per_title": 1}),
        ("doppel.encode.token_sort", {"titles": 1, "per_title": 1}),
    ]


@pytest.mark.parametrize("n", [1, 40])
def test_encode_titles_raises_on_non_ascii_within_the_cut(n, route):
    ok = ["abc"] * (n - 1)
    with pytest.raises(UnicodeEncodeError):
        T.encode_titles(ok + ["café"], 255)
    # past the cut a character is never read, as in the loop
    far = "a" * 10 + "é"
    np.testing.assert_array_equal(T.encode_titles(ok + [far], 10),
                                  T.encode_titles_plain(ok + [far], 10))


def test_token_sort_follows_str_order():
    """Digits sort before letters in ``str`` order, though their codes
    (28-37) lie above the letters' (2-27)."""
    enc, ln = T.token_sorted_codes(["b1 a 1a 0 ab a"] * T.FLAT_MIN_TITLES, T.MAX_CHARACTERS)
    assert T.decode_title(enc[0]) == "0 1a a a ab b1"
    assert ln[0] == len("0 1a a a ab b1")


def test_matcher_takes_the_truths_token_sort(tmp_path):
    """Construction's token-sort piece is the truth's lazy property."""
    import torch

    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, truth, _, _ = synthetic.make_synthetic_world(2000, 10)
        m = Matcher(cfg.with_(data_path=str(tmp_path), title_block=2048), truth,
                    GBTModel.load(str(MODEL)), device="cpu", use_index_checkpoint=False)
    finally:
        torch.set_num_threads(threads)
    assert "token_sort" in m.init_seconds
    assert m.ts_truth is truth.encoded_token_sorted
    _assert_equal(truth, _oracle(truth.titles))
