"""Host-side text primitives: normalization, char codec, trigram ids, IDF.

numpy and pure Python, equal to the JAX package's ``utils/text.py`` (its C++
fast path is not carried; the tests hold this module equal to it).

A batch of titles takes the flat route: every title's characters laid end
to end in one byte buffer, mapped through one table and compacted with
masks over the flat array, then scattered into the codes' rows
(``transform_encode_titles``, ``encode_titles``, ``spaceless_codes``,
``token_sorted_codes``).  A title that is not ASCII takes
``transform_title``, whose NFD no table can stand for, and a batch under
``FLAT_MIN_TITLES`` takes the per-title loops whole.  The ``*_plain``
functions are those loops, kept also as the tests' oracle.
"""

from __future__ import annotations

import math
import re
import unicodedata
from collections import Counter
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from doppelspeller_tpu_torch.config import ALPHABET, N_TEXT_CHARS, PAD_CODE, TRIGRAM_VOCAB_SIZE

MAX_CHARACTERS = 255
N_GRAMS = 3

_KEEP_RE = re.compile(r"[^a-zA-Z0-9\s]+")
_WS_RE = re.compile(r"\s")
_SPACES_RE = re.compile(r" +")

# char -> uint8 code ('-'=0 pad, ' '=1, 'a'..'z'=2..27, '0'..'9'=28..37)
CHAR_ENCODING = {ch: i for i, ch in enumerate(ALPHABET)}
CHAR_DECODING = {i: ch for ch, i in CHAR_ENCODING.items()}

# uint8 code -> trigram text-char id (space=0, a..z=1..26, 0..9=27..36);
# the pad code maps to -1
_FEATURE_TO_TEXT = np.full(256, -1, dtype=np.int32)
for _ch, _code in CHAR_ENCODING.items():
    if _ch == "-":
        continue
    if _ch == " ":
        _FEATURE_TO_TEXT[_code] = 0
    elif "a" <= _ch <= "z":
        _FEATURE_TO_TEXT[_code] = 1 + (ord(_ch) - ord("a"))
    else:
        _FEATURE_TO_TEXT[_code] = 27 + (ord(_ch) - ord("0"))

_ASCII_LUT = np.zeros(256, dtype=np.uint8)
for _ch, _code in CHAR_ENCODING.items():
    _ASCII_LUT[ord(_ch)] = _code
_SPACE_CODE = CHAR_ENCODING[" "]

# byte -> the byte ``transform_title`` keeps for it in an ASCII title:
# A-Z lowered, a-z and 0-9 kept, '-' and every character str's ``\s``
# matches in ASCII (\x1c-\x1f among them) a space; 0 drops the byte
_SPACE = ord(" ")
_TRANSFORM_BYTE = np.zeros(256, dtype=np.uint8)
for _b in range(128):
    _c = chr(_b)
    if "a" <= _c <= "z" or "0" <= _c <= "9":
        _TRANSFORM_BYTE[_b] = _b
    elif "A" <= _c <= "Z":
        _TRANSFORM_BYTE[_b] = ord(_c.lower())
    elif _c == "-" or _WS_RE.match(_c):
        _TRANSFORM_BYTE[_b] = _SPACE
# ends each title in the flat route's buffer; the table never makes it
_SEP = "\n"
_SEP_BYTE = ord(_SEP)

# a batch of fewer titles takes the per-title loops: the flat route's fixed
# numpy cost (~40 µs to transform and encode, against the loops' ~6 µs a
# title on an x86 server core) pays only from about ten titles on
FLAT_MIN_TITLES = 10

BIG_TRIGRAM = np.int32(1 << 30)  # sorts after every real trigram id


def transform_title(title: str, max_characters: int = MAX_CHARACTERS,
                    n_grams: int = N_GRAMS) -> str:
    """Lower-case alphanumeric normal form: NFD, drop non-ascii, '-' → space,
    keep [a-z0-9 ], collapse spaces, trim, truncate, left-pad with '0' to at
    least ``n_grams`` characters."""
    text = unicodedata.normalize("NFD", title)
    text = text.encode("ascii", "ignore").decode("utf-8").lower().replace("-", " ")
    text = _KEEP_RE.sub("", text)
    text = _WS_RE.sub(" ", text)
    text = _SPACES_RE.sub(" ", text).strip()
    n_chars = len(text)
    text = text[:max_characters].strip()
    if n_chars < n_grams:
        return text.rjust(n_grams, "0")
    return text


def transform_titles_plain(titles: Iterable[str], max_characters: int = MAX_CHARACTERS,
                           n_grams: int = N_GRAMS) -> List[str]:
    """``transform_title`` of each title, one at a time."""
    return [transform_title(t, max_characters, n_grams) for t in titles]


def _dest(lens: np.ndarray, width: int) -> np.ndarray:
    """Flat index into uint8[B, width] of every character of rows of
    ``lens`` (each at most ``width``) characters laid end to end."""
    starts = np.cumsum(lens) - lens
    dest = np.repeat(np.arange(len(lens), dtype=np.int64) * width - starts, lens)
    dest += np.arange(len(dest), dtype=np.int64)        # in place: one large array fewer
    return dest


def _scatter(lens: np.ndarray, codes: np.ndarray, width: int) -> np.ndarray:
    """uint8[B, width]: rows of ``lens`` of ``codes`` laid end to end, zero-padded."""
    out = np.zeros((len(lens), width), dtype=np.uint8)
    out.reshape(-1)[_dest(lens, width)] = codes
    return out


def _cut(ch: np.ndarray, n_chars: np.ndarray, max_characters: int) -> np.ndarray:
    """``text[:max_characters].strip()`` of each title in ``ch``: titles of
    ``n_chars`` characters with no space at either end, each ended by
    ``_SEP_BYTE``."""
    end = ch == _SEP_BYTE
    row = np.cumsum(end) - end
    pos = np.arange(len(ch), dtype=np.int64) - (np.cumsum(n_chars + 1) - n_chars - 1)[row]
    return ch[end | ((pos < max_characters)
                     & ~((pos == max_characters - 1) & (ch == _SPACE)))]


def _transform_encode_ascii(titles: Sequence[str], joined: str, max_characters: int,
                            n_grams: int) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """``transform_encode_titles`` of ASCII titles, all by the flat route
    (``joined``: ``_SEP.join(titles)``)."""
    B = len(titles)
    if B == 0:
        return [], np.zeros((0, max_characters), np.uint8), np.zeros(0, np.int32)
    ch = np.take(_TRANSFORM_BYTE, np.frombuffer((joined + _SEP).encode("ascii"), dtype=np.uint8))
    # each title's end, in place of the separator the table made a space
    ch[np.cumsum(np.fromiter(map(len, titles), dtype=np.int64, count=B) + 1) - 1] = _SEP_BYTE
    ch = ch[ch != 0]
    # a space stays only after a letter or digit: runs collapse to their
    # first space and leading spaces go (the end byte sorts below a space)
    prev = np.empty_like(ch)
    prev[0], prev[1:] = _SEP_BYTE, ch[:-1]
    ch = ch[(ch != _SPACE) | (prev > _SPACE)]
    # ... and before one: a trailing space goes
    ch = ch[np.append((ch[:-1] != _SPACE) | (ch[1:] != _SEP_BYTE), True)]
    n_chars = lengths = np.diff(np.flatnonzero(ch == _SEP_BYTE), prepend=-1) - 1
    if n_chars.max() > max_characters:
        ch = _cut(ch, n_chars, max_characters)
        lengths = np.diff(np.flatnonzero(ch == _SEP_BYTE), prepend=-1) - 1
    lengths = lengths.astype(np.int32)
    transformed = ch.tobytes().decode("ascii").split(_SEP)[:B]
    encoded = _scatter(lengths, np.take(_ASCII_LUT, ch[ch != _SEP_BYTE]), max_characters)
    for i in np.flatnonzero(n_chars < n_grams):
        t = transformed[i] = transformed[i].rjust(n_grams, "0")
        encoded[i] = encode_titles_plain([t], max_characters)[0]
        lengths[i] = min(len(t), max_characters)
    return transformed, encoded, lengths


def transform_encode_titles(titles: Sequence[str], max_characters: int = MAX_CHARACTERS,
                            n_grams: int = N_GRAMS
                            ) -> Tuple[List[str], np.ndarray, np.ndarray, int]:
    """(transformed list[str], encoded uint8[B, max_characters], lengths
    int32[B], per_title): ``transform_title`` of each title, its codes as
    ``encode_titles`` gives them and its length within ``max_characters``.
    ASCII titles take the flat route; the ``per_title`` others, or every
    title of a batch under ``FLAT_MIN_TITLES``, take ``transform_title`` one
    at a time, and their rows land in place."""
    if len(titles) < FLAT_MIN_TITLES:
        transformed = transform_titles_plain(titles, max_characters, n_grams)
        lengths = np.array([min(len(t), max_characters) for t in transformed], dtype=np.int32)
        return (transformed, encode_titles_plain(transformed, max_characters), lengths,
                len(titles))
    joined = _SEP.join(titles)
    if joined.isascii():
        return (*_transform_encode_ascii(titles, joined, max_characters, n_grams), 0)
    other = [i for i, t in enumerate(titles) if not t.isascii()]
    flat = list(titles)
    for i in other:
        flat[i] = ""
    transformed, encoded, lengths = _transform_encode_ascii(flat, _SEP.join(flat), max_characters,
                                                            n_grams)
    for i in other:
        t = transformed[i] = transform_title(titles[i], max_characters, n_grams)
        encoded[i] = encode_titles_plain([t], max_characters)[0]
        lengths[i] = min(len(t), max_characters)
    return transformed, encoded, lengths, len(other)


def get_n_grams(title: str, n: int = N_GRAMS) -> set:
    """Set of all character n-grams of ``title``."""
    return {title[i : i + n] for i in range(len(title) - n + 1)}


def get_words_counter(words_lists: Iterable[Sequence[str]]) -> Counter:
    """Document-frequency counter: each word counted once per title."""
    counter: Counter = Counter()
    for words in words_lists:
        counter.update(set(words))
    return counter


def idf_word(word: str, words_counter: Counter, number_of_titles: int) -> float:
    """Natural-log inverse document frequency of ``word``."""
    return math.log(number_of_titles / words_counter[word])


def encode_title(title: str, max_characters: int = MAX_CHARACTERS) -> np.ndarray:
    """uint8[max_characters] char codes, zero-padded."""
    return encode_titles([title], max_characters)[0]


def decode_title(codes: np.ndarray) -> str:
    """The title of ``encode_title``'s codes (pads dropped)."""
    return "".join(CHAR_DECODING[int(c)] for c in codes if c != PAD_CODE)


def encode_titles(titles: Sequence[str], max_characters: int = MAX_CHARACTERS) -> np.ndarray:
    """uint8[B, max_characters] char codes, zero-padded: one buffer of all
    the titles (one title at a time under ``FLAT_MIN_TITLES``); a non-ASCII
    character in a title's first ``max_characters`` raises
    ``UnicodeEncodeError``."""
    if len(titles) < FLAT_MIN_TITLES:
        return encode_titles_plain(titles, max_characters)
    try:
        buf = np.frombuffer("".join(titles).encode("ascii"), dtype=np.uint8)
    except UnicodeEncodeError:
        # raises where the title at fault lies within the cut, as the loop does
        return encode_titles_plain(titles, max_characters)
    lens = np.fromiter(map(len, titles), dtype=np.int64, count=len(titles))
    codes = np.take(_ASCII_LUT, buf)
    if lens.max(initial=0) > max_characters:
        row = np.repeat(np.arange(len(lens)), lens)
        codes = codes[np.arange(len(codes)) - (np.cumsum(lens) - lens)[row] < max_characters]
        lens = np.minimum(lens, max_characters)
    return _scatter(lens, codes, max_characters)


def encode_titles_plain(titles: Sequence[str], max_characters: int = MAX_CHARACTERS) -> np.ndarray:
    """``encode_titles``, one title at a time."""
    out = np.zeros((len(titles), max_characters), dtype=np.uint8)
    for i, t in enumerate(titles):
        b = np.frombuffer(t[:max_characters].encode("ascii"), dtype=np.uint8)
        out[i, : len(b)] = _ASCII_LUT[b]
    return out


def spaceless_codes(encoded: np.ndarray, lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8[B, L], int32[B]): each row's codes within its length with the
    spaces taken out, compacted over the flat characters."""
    L = encoded.shape[1]
    lens = np.minimum(lengths, L).astype(np.int64)
    codes = encoded.reshape(-1)[_dest(lens, L)]
    space = codes == _SPACE_CODE
    before = np.zeros(len(codes) + 1, dtype=np.int32)      # spaces before each character
    np.cumsum(space, out=before[1:])
    ends = np.cumsum(lens)
    n = lens - (before[ends] - before[ends - lens])
    return _scatter(n, codes[~space], L), n.astype(np.int32)


def spaceless_codes_plain(transformed: Sequence[str], max_characters: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """``spaceless_codes`` of the titles' codes, from their strings one at a time."""
    wo = [t[:max_characters].replace(" ", "") for t in transformed]
    return (encode_titles_plain(wo, max_characters),
            np.array([min(len(t), max_characters) for t in wo], dtype=np.int32))


def token_sorted_codes(transformed: Sequence[str], max_characters: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8[B, max_characters], int32[B]): each title's words sorted in
    ``str`` order and joined with single spaces, encoded by the flat route."""
    ts = [" ".join(sorted(t.split())) for t in transformed]
    lens = np.fromiter(map(len, ts), dtype=np.int64, count=len(ts))
    return encode_titles(ts, max_characters), np.minimum(lens, max_characters).astype(np.int32)


def token_sorted_codes_plain(transformed: Sequence[str], max_characters: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """``token_sorted_codes``, encoded one title at a time."""
    ts = [" ".join(sorted(t.split())) for t in transformed]
    return (encode_titles_plain(ts, max_characters),
            np.array([min(len(t), max_characters) for t in ts], dtype=np.int32))


def trigram_ids_from_codes(codes: np.ndarray, length: int) -> np.ndarray:
    """Sorted unique trigram ids (int32) of one encoded title:
    id(c0, c1, c2) = c0·37² + c1·37 + c2 over the text-char ids."""
    if length < 3:
        raise ValueError("transformed titles are always >= 3 chars")
    text = _FEATURE_TO_TEXT[codes[:length]]
    ids = text[:-2] * (N_TEXT_CHARS * N_TEXT_CHARS) + text[1:-1] * N_TEXT_CHARS + text[2:]
    return np.unique(ids.astype(np.int32))


def trigram_ids_matrix(encoded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """int32[B, L_eff-2] per-title unique trigram ids, sorted ascending, with
    invalid and duplicate slots set to BIG_TRIGRAM (L_eff = longest title)."""
    B, L = encoded.shape
    L_eff = int(lengths.max(initial=3)) if B else 3
    if L_eff < L:
        encoded = encoded[:, :L_eff]
        L = L_eff
    text = _FEATURE_TO_TEXT[encoded]
    ids = (
        text[:, :-2] * (N_TEXT_CHARS * N_TEXT_CHARS)
        + text[:, 1:-1] * N_TEXT_CHARS
        + text[:, 2:]
    ).astype(np.int64)
    pos = np.arange(L - 2, dtype=np.int32)[None, :]
    valid = pos <= (lengths[:, None] - 3)
    ids = np.where(valid, ids, np.int64(BIG_TRIGRAM))
    ids.sort(axis=1)
    dup = np.zeros_like(ids, dtype=bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    ids = np.where(dup, np.int64(BIG_TRIGRAM), ids)
    ids.sort(axis=1)
    return ids.astype(np.int32)


def trigram_df(ids: np.ndarray) -> np.ndarray:
    """int32[V] document frequency of every trigram id in ``ids``
    (``trigram_ids_matrix``'s rows): the titles that hold it."""
    return np.bincount(ids[ids != BIG_TRIGRAM], minlength=TRIGRAM_VOCAB_SIZE).astype(np.int32)


def trigram_df_table(encoded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """``trigram_df`` of these encoded titles."""
    return trigram_df(trigram_ids_matrix(encoded, lengths))


def idf_table_from_df(df: np.ndarray, number_of_titles: int) -> np.ndarray:
    """float32[V] IDF table: ln(N/df) where df > 0, else 0."""
    idf = np.zeros_like(df, dtype=np.float32)
    nz = df > 0
    idf[nz] = np.log(number_of_titles / df[nz].astype(np.float64)).astype(np.float32)
    return idf
