"""The tile rules that the planners, the batch cascade, the one-dispatch
path and the host stages must agree on, each written once: they size
kernel tiles, graph keys and query blocks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.utils.text import BIG_TRIGRAM


def query_block(cfg: Config, folded: bool) -> int:
    """The queries of a retrieval block: ``fold_query_block`` (0 meaning
    ``query_block``) on the folded engine, ``query_block`` on the exact one."""
    return int(cfg.fold_query_block or cfg.query_block) if folded else int(cfg.query_block)


def trigram_block(ids: np.ndarray, cfg: Config) -> Tuple[np.ndarray, int]:
    """(ids, LQ) of queries' trigram ids (``BIG_TRIGRAM`` past each query's):
    LQ is the smallest of (max_query_trigrams, 128, 253) that holds every
    query's trigrams (253 past them all); ids narrower are padded to it."""
    need = int((ids != BIG_TRIGRAM).sum(axis=1).max(initial=1))
    lq = next(b for b in (cfg.max_query_trigrams, 128, 253) if need <= b or b == 253)
    if ids.shape[1] < lq:
        ids = np.concatenate([ids, np.full((ids.shape[0], lq - ids.shape[1]), BIG_TRIGRAM, np.int32)],
                             axis=1)
    return ids, lq


def _below(buckets: Sequence[int], width: int) -> List[int]:
    return [b for b in buckets if b < width] + [width]


def title_grid(cfg: Config, width: int) -> List[int]:
    """Title-length buckets of encodings ``width`` wide."""
    return _below(cfg.length_buckets, width)


def device_word_grid(width: int) -> List[int]:
    """Word-length buckets of the device cascade's model tiles (the batch
    waves and the one-dispatch graph)."""
    return _below((16, 32, 64), width)


def host_word_grid(width: int, every: bool = False) -> List[int]:
    """Word-length buckets of the host stages' and the feature builders'
    pairs.  ``every`` keeps all four before the width, as the reference's
    host model stage and ``construct_features`` write them (a pair whose
    word bucket is wider than its title's stays unscored); the two agree on
    encodings wider than 64."""
    buckets = (8, 16, 32, 64)
    return list(buckets) + [width] if every else _below(buckets, width)


def fuzzy_tile_bound(q_len: np.ndarray, cfg: Config) -> np.ndarray:
    """The longest truth title that the fuzzy length-delta prefilter lets a
    query of each length consider, ⌈q·(200−thr)/thr⌉ capped at
    ``max_characters``: the fuzzy tile no considered pair overflows."""
    thr = int(cfg.levenshtein_ratio_threshold)
    q = np.asarray(q_len, dtype=np.int64)
    return np.minimum((q * (200 - thr) + thr - 1) // thr, cfg.max_characters)
