"""On-device construction of the truth index.

The JAX package's ``ops/index_device.py``.  Only the encoded titles cross
to the device.  There, a block of titles at a time, each title's trigram
ids are computed and deduplicated by an in-row sort (``title_trigram_ids``)
and the document frequencies add up as an integer bincount per block
(``build_shard``).  The IDF table is computed on the host from the
downloaded frequencies, as both of the JAX package's builds do
(``torch.log`` on the card does not round as numpy's ``log`` does).  The
per-title IDF sums then add on the device in float64, left to right over
each title's sorted ids (``shard_sums``): the order of the host build
(``ngram_index.build_truth_index``), so the two builds give the same bits.

The ids are dropped once the index is downloaded: the packed matrix
uploads the index's ``trigrams`` (``ngram_index.build_packed_matrix``),
and the folded engine builds its folded matrices and trigram lists from
ids it computes once on its device with ``build_shard``
(``ops/fold.py``).  A mesh builds each shard on its own device from its
slice of the encodings (``build_shard`` and ``shard_sums``, the JAX
``shard_build_fn`` and ``shard_sums_fn``;
``parallel/sharded.build_sharded_index``).

The JAX module's page layout (``_build_stripe``, the TPU kernel's
``(V, 32, W)`` gather view) is not ported: the port's kernels read the
natural ``(V, ntp/8)`` layout through ids.
"""

from __future__ import annotations

import logging
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from doppelspeller_tpu_torch.config import N_TEXT_CHARS, TRIGRAM_VOCAB_SIZE, Config
from doppelspeller_tpu_torch.device import resolve_device, synchronize
from doppelspeller_tpu_torch.ops.ngram_index import TruthIndex, _round_up, title_content_hash
from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)

V = TRIGRAM_VOCAB_SIZE
N = N_TEXT_CHARS
BLOCK = 32768       # titles a step: bounds the scratch, as in the JAX module


def ids_width(lengths: np.ndarray) -> int:
    """L_eff - 2, the width of the id rows (L_eff: the longest title, at
    least 3), as ``utils/text.trigram_ids_matrix`` cuts them."""
    return int(lengths.max(initial=3)) - 2


def title_trigram_ids(enc: torch.Tensor, lengths: torch.Tensor, width: int) -> torch.Tensor:
    """int32[B, width] per-title trigram ids on the tensors' device, sorted,
    each repeat and each slot past the title set to V in place: the JAX
    ``_device_trigram_ids`` cut to ``width`` (the trigram lists' layout).

    ``enc`` uint8[B, >= width + 2] char codes, ``lengths`` integer[B]."""
    lut = torch.from_numpy(T._FEATURE_TO_TEXT).to(enc.device)
    text = lut[enc[:, : width + 2].long()]                   # (B, width + 2), -1 pads
    ids = text[:, :-2] * (N * N) + text[:, 1:-1] * N + text[:, 2:]
    pos = torch.arange(width, device=enc.device)
    valid = pos[None, :] <= lengths[:, None].long() - 3
    ids = torch.where(valid, ids, V).sort(dim=1).values
    dup = torch.zeros_like(valid)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    return ids.masked_fill(dup, V)


def sorted_ids(ids: torch.Tensor) -> torch.Tensor:
    """``title_trigram_ids``' rows in ``trigram_ids_matrix``'s layout: the
    unique ids first, sorted, then BIG_TRIGRAM."""
    return torch.where(ids == V, int(T.BIG_TRIGRAM), ids).sort(dim=1).values


def device_trigram_ids(enc: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """int32[B, L_eff - 2] on the tensors' device, equal to
    ``utils/text.trigram_ids_matrix`` of the same encodings bit for bit."""
    return sorted_ids(title_trigram_ids(enc, lengths, ids_width(lengths.cpu().numpy())))


def build_shard(encoded: np.ndarray, lengths: np.ndarray, device, width: int,
                block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids int32[n, width], df int64[V]) on ``device`` for these n titles:
    ``title_trigram_ids`` built a block of titles at a time from the
    uploaded encodings (their first ``width + 2`` columns), and the
    document frequencies, an integer bincount per block."""
    device = torch.device(device)
    n = len(lengths)
    ids = torch.empty((n, width), dtype=torch.int32, device=device)
    df = torch.zeros(V + 1, dtype=torch.int64, device=device)
    for s in range(0, n, block):
        enc = torch.from_numpy(np.ascontiguousarray(encoded[s : s + block, : width + 2]))
        lens = torch.from_numpy(lengths[s : s + block].astype(np.int32))
        blk = title_trigram_ids(enc.to(device), lens.to(device), width)
        ids[s : s + block] = blk
        df += torch.bincount(blk.flatten(), minlength=V + 1)
    return ids, df[:V]


def shard_sums(ids: torch.Tensor, idf: np.ndarray, block: int = BLOCK) -> torch.Tensor:
    """float32[n] per-title IDF sums of ``build_shard``'s ids, on their
    device: float64, added left to right over each title's id columns (V
    adds 0), then rounded to float32, as the host build adds them."""
    w = torch.from_numpy(np.append(idf, 0.0).astype(np.float64)).to(ids.device)
    out = torch.empty(ids.shape[0], dtype=torch.float32, device=ids.device)
    for s in range(0, ids.shape[0], block):
        g = w[ids[s : s + block].long()]                      # (B, width) float64
        acc = torch.zeros(g.shape[0], dtype=torch.float64, device=ids.device)
        for c in range(g.shape[1]):
            acc += g[:, c]
        out[s : s + block] = acc.float()
    return out


def index_from_shards(truth: TitleSet, config: Config,
                      shards: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      block: int = BLOCK) -> TruthIndex:
    """The host ``TruthIndex`` of ``build_shard``'s outputs, which cover the
    titles in order: the frequencies summed on the first shard's device,
    IDF on the host, each shard's sums on its device, the ids downloaded in
    ``trigram_ids_matrix``'s layout.  Bit for bit the host build's."""
    nt = len(truth)
    ntp = _round_up(max(nt, config.title_block), config.title_block)
    first = shards[0][1].device
    df = sum(d.to(first) for _, d in shards).cpu().numpy().astype(np.int32)
    idf = T.idf_table_from_df(df, nt)
    sums = np.zeros(ntp, dtype=np.float32)
    sums[:nt] = torch.cat([shard_sums(ids, idf, block).cpu() for ids, _ in shards]).numpy()
    trigrams: List[np.ndarray] = [sorted_ids(ids[s : s + block]).cpu().numpy()
                                  for ids, _ in shards for s in range(0, ids.shape[0], block)]
    width = shards[0][0].shape[1]
    return TruthIndex(
        idf=idf, df=df, sums=sums, title_ids=truth.ids.copy(), num_titles=nt, padded_titles=ntp,
        max_idf=float(idf.max()) if nt > 0 else 0.0,
        trigrams=np.concatenate(trigrams) if trigrams else np.zeros((0, width), np.int32),
        content_hash=title_content_hash(truth.encoded, truth.lengths), built_on="device",
    )


def build_truth_index_device(truth: TitleSet, config: Config, device,
                             block: int = BLOCK) -> TruthIndex:
    """``ngram_index.build_truth_index`` built on ``device`` from the
    uploaded encodings, in blocks of ``block`` titles; equal to the host
    build bit for bit."""
    device = resolve_device(device)
    t0 = time.time()
    shard = build_shard(truth.encoded, truth.lengths, device, ids_width(truth.lengths), block)
    index = index_from_shards(truth, config, [shard], block)
    synchronize(device)
    LOGGER.info("[TruthIndex] device build on %s: %d titles (padded %d) in %.3f s",
                device, index.num_titles, index.padded_titles, time.time() - t0)
    return index
