"""The truth-title trigram index and the exact path's query-block planner.

The JAX package's ``ops/ngram_index.py``.  ``TruthIndex`` holds the
statistics every retrieval path reads (document frequencies, IDF, per-title
sums) and the per-title trigram ids.  The bit-packed (V, ntp/8) occupancy
matrix is built only when the exact retrieval engine asks for it
(``build_packed_matrix``): at 500k titles it takes 3.3 GB, and the folded
path never reads it (it builds its own folded matrix, ``ops/fold.py``).

``build_truth_index`` resolves ``index_build_impl`` as the JAX package
does: on a CUDA device ``"auto"`` takes the device build
(``ops/index_device.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from doppelspeller_tpu_torch.config import TRIGRAM_VOCAB_SIZE, Config
from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils.io import TitleSet


# the checkpoint's format tag: a file without it (the JAX package's
# ``index.npz``, which holds the packed matrix) is not this package's
INDEX_FORMAT = "doppelspeller_tpu_torch.TruthIndex/1"
_INDEX_ARRAYS = ("idf", "df", "sums", "title_ids", "trigrams")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def title_content_hash(encoded: np.ndarray, lengths: np.ndarray) -> str:
    """Digest of the encoded titles: detects truth-title edits that keep the
    same ids and count (the checkpoint's staleness guard)."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(lengths.astype(np.int32)).tobytes())
    h.update(np.ascontiguousarray(encoded).tobytes())
    return h.hexdigest()


def _check_format(z, path: str) -> None:
    if "format" not in z.files or str(z["format"]) != INDEX_FORMAT:
        raise ValueError(f"{path} is not a {INDEX_FORMAT} checkpoint")


def checkpoint_holds(path: str, truth: TitleSet) -> bool:
    """Whether the checkpoint at ``path`` holds exactly ``truth`` (count,
    ids, content hash), read without its trigram rows; ValueError for a
    file of another format."""
    with np.load(path) as z:
        _check_format(z, path)
        return (int(z["num_titles"]) == len(truth) and np.array_equal(z["title_ids"], truth.ids)
                and str(z["content_hash"]) == title_content_hash(truth.encoded, truth.lengths))


@dataclass
class TruthIndex:
    idf: np.ndarray         # float32[V] ln(N/df), 0 for unobserved trigrams
    df: np.ndarray          # int32[V] document frequency
    sums: np.ndarray        # float32[ntp] per-title IDF sum (0 for padding)
    title_ids: np.ndarray   # int64[nt] external title ids
    num_titles: int         # nt
    padded_titles: int      # ntp, a multiple of title_block
    max_idf: float          # fallback IDF for query trigrams absent in truth
    trigrams: np.ndarray    # int32[nt, W] per-title sorted unique trigram ids,
                            #   BIG_TRIGRAM in unused slots
    content_hash: str = ""  # title_content_hash of the truth titles
    # the build that made the index, "host" or "device" ("" after a load)
    built_on: str = field(default="", compare=False)

    @property
    def vocab_size(self) -> int:
        return self.idf.shape[0]

    @property
    def packed_nbytes(self) -> int:
        """Logical size of the bit-packed (V, ntp/8) matrix, which the exact
        engine builds on the device from the trigram ids."""
        return self.vocab_size * (self.padded_titles // 8)

    def save(self, path: str) -> None:
        """Checkpoint the index: its statistics, the trigram ids and the
        content hash, under ``INDEX_FORMAT``."""
        np.savez_compressed(
            path, format=np.str_(INDEX_FORMAT),
            **{k: getattr(self, k) for k in _INDEX_ARRAYS},
            num_titles=np.int64(self.num_titles), padded_titles=np.int64(self.padded_titles),
            max_idf=np.float32(self.max_idf), content_hash=np.str_(self.content_hash),
        )

    @classmethod
    def load(cls, path: str) -> "TruthIndex":
        """Read a checkpoint of ``save``; ValueError for a file of another
        format."""
        with np.load(path) as z:
            _check_format(z, path)
            return cls(**{k: z[k] for k in _INDEX_ARRAYS},
                       num_titles=int(z["num_titles"]), padded_titles=int(z["padded_titles"]),
                       max_idf=float(z["max_idf"]), content_hash=str(z["content_hash"]))

    def fallback_idf(self) -> np.ndarray:
        """float32[V] per-trigram weight of the max-intersection bound: the
        IDF where the trigram is observed in truth, else ``max_idf``."""
        return np.where(self.df > 0, self.idf, np.float32(self.max_idf)).astype(np.float32)


def _or_default(device) -> torch.device:
    """``device``, or for None the default device, as the JAX package builds
    on its default backend: the card where there is one, else the CPU."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def index_build_impl(config: Config, device=None) -> str:
    """"device" or "host": the build ``build_truth_index`` takes on
    ``device`` under ``config.index_build_impl``, resolved as the JAX
    package resolves it on its backend: ``"auto"`` the device build on a
    CUDA device and the host build on the CPU, ``"device"`` the device
    build on any device, anything else the host build.  ``device=None``
    is the default device (``_or_default``)."""
    impl = config.index_build_impl
    if impl == "auto":
        return "device" if _or_default(device).type == "cuda" else "host"
    return "device" if impl == "device" else "host"


def build_truth_index(truth: TitleSet, config: Config, device=None) -> TruthIndex:
    """IDF = ln(N/df) over per-title-unique trigrams; per-title IDF sums
    added in float64, left to right over each title's sorted ids, and
    stored as float32.

    Where ``index_build_impl`` resolves to "device" on ``device`` (None:
    the card where there is one, else the CPU) the index is built there
    (``index_device.build_truth_index_device``), bit for bit this host
    build."""
    device = _or_default(device)
    if index_build_impl(config, device) == "device":
        from doppelspeller_tpu_torch.ops.index_device import build_truth_index_device

        return build_truth_index_device(truth, config, device)
    nt = len(truth)
    ntp = _round_up(max(nt, config.title_block), config.title_block)
    ids = truth.trigram_ids()                                # (nt, W), BIG pad
    valid = ids != T.BIG_TRIGRAM
    df = T.trigram_df(ids)
    idf = T.idf_table_from_df(df, nt)
    max_idf = float(idf.max()) if nt > 0 else 0.0
    w = np.where(valid, idf[np.minimum(ids, TRIGRAM_VOCAB_SIZE - 1)].astype(np.float64), 0.0)
    acc = np.zeros(nt, dtype=np.float64)
    for c in range(w.shape[1]):            # the device build's order
        acc += w[:, c]
    sums = np.zeros(ntp, dtype=np.float32)
    sums[:nt] = acc.astype(np.float32)
    return TruthIndex(
        idf=idf, df=df, sums=sums, title_ids=truth.ids.copy(), num_titles=nt,
        padded_titles=ntp, max_idf=max_idf, trigrams=ids,
        content_hash=title_content_hash(truth.encoded, truth.lengths), built_on="host",
    )


def build_packed_matrix(index: TruthIndex, device) -> torch.Tensor:
    """uint8[V, ntp/8] on ``device``: bit t % 8 of byte t // 8 in row g is
    set when title t holds trigram g (natural title order).

    A title's trigram ids are unique, so within one bit plane (titles with
    the same t % 8) every (row, byte) pair is written once: eight
    gather-or-scatter passes, with no scratch beyond the matrix itself."""
    ntp = index.padded_titles
    nbytes = ntp // 8
    ids = torch.from_numpy(index.trigrams).to(device)
    t = torch.arange(ids.shape[0], device=device)[:, None].expand_as(ids)
    keep = ids < TRIGRAM_VOCAB_SIZE
    t = t[keep]
    byte = ids[keep].to(torch.int64) * nbytes + t // 8
    bit = t % 8
    packed = torch.zeros(TRIGRAM_VOCAB_SIZE * nbytes, dtype=torch.uint8, device=device)
    for s in range(8):
        sel = byte[bit == s]
        packed[sel] = packed[sel] | (1 << s)
    return packed.reshape(TRIGRAM_VOCAB_SIZE, nbytes)


@dataclass
class QueryBlockPlan:
    """One exact-retrieval block: ≤ query_block queries whose trigram-id
    union fits in ``union_ids`` (a size from ``union_buckets``)."""

    query_rows: np.ndarray        # int64[n_valid] row numbers into the query set
    union_ids: np.ndarray         # int32[U] gather rows (padded with 0)
    w_pos: np.ndarray             # int32[query_block, LQ] positions into the
                                  #   union; U is the padding slot
    w_val: np.ndarray             # float32[query_block, LQ] IDF weights
    max_intersection: np.ndarray  # float32[query_block] union-IDF upper bound
    n_valid: int


def plan_query_blocks(queries: TitleSet, index: TruthIndex, config: Config,
                      rows: Optional[np.ndarray] = None) -> List[QueryBlockPlan]:
    """Pack queries into blocks of ``query_block`` with a trigram-id union
    of at most ``max(union_buckets)`` slots; a block whose union overflows
    is split in half recursively (in order, so the plans keep the order of
    ``rows``).  LQ is the smallest of (max_query_trigrams, 128, 253) that
    holds every query's trigrams.  ``w_val`` is the real IDF (0 for a
    trigram unobserved in truth); ``max_intersection`` sums the
    IDF-or-max-IDF fallback in float64."""
    cfg = config
    if rows is None:
        rows = np.arange(len(queries), dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return []
    qb = cfg.query_block
    buckets = sorted(cfg.union_buckets or (qb * 32,))
    union_cap = buckets[-1]
    BIG = T.BIG_TRIGRAM

    ids_all = queries.trigram_ids()[rows]
    valid_all = ids_all != BIG
    need = int(valid_all.sum(axis=1).max(initial=1))
    lq = next(b for b in (cfg.max_query_trigrams, 128, 253) if need <= b or b == 253)
    if ids_all.shape[1] < lq:
        ids_all = np.concatenate([
            ids_all, np.full((ids_all.shape[0], lq - ids_all.shape[1]), BIG, np.int32),
        ], axis=1)
        valid_all = ids_all != BIG
    lq = min(lq, ids_all.shape[1])

    clipped = np.clip(ids_all, 0, index.idf.shape[0] - 1)
    idf_g = index.idf[clipped]
    w_fb = np.where(index.df[clipped] > 0, idf_g, np.float32(index.max_idf))
    maxint_all = (w_fb * valid_all).sum(axis=1, dtype=np.float64).astype(np.float32)

    plans: List[QueryBlockPlan] = []

    def emit(sel: np.ndarray) -> None:
        blk_ids = ids_all[sel]
        union = np.unique(blk_ids)
        union = union[union != BIG]
        if len(union) > union_cap:
            mid = max(len(sel) // 2, 1)
            emit(sel[:mid])
            emit(sel[mid:])
            return
        m = len(sel)
        u_size = next(b for b in buckets if len(union) <= b)
        union_ids = np.zeros(u_size, dtype=np.int32)
        union_ids[: len(union)] = union
        v = valid_all[sel][:, :lq]
        pos = np.where(v, np.searchsorted(union, blk_ids[:, :lq]), u_size)
        w_pos = np.full((qb, lq), u_size, dtype=np.int32)
        w_val = np.zeros((qb, lq), dtype=np.float32)
        w_pos[:m] = pos
        w_val[:m] = idf_g[sel][:, :lq] * v
        maxint = np.zeros(qb, dtype=np.float32)
        maxint[:m] = maxint_all[sel]
        plans.append(QueryBlockPlan(query_rows=rows[sel], union_ids=union_ids, w_pos=w_pos,
                                    w_val=w_val, max_intersection=maxint, n_valid=m))

    for start in range(0, len(rows), qb):
        emit(np.arange(start, min(start + qb, len(rows)), dtype=np.int64))
    return plans
