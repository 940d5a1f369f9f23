"""The table of peaks and the count of retrieval's scoring work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
power limit): the tensor cores' rate in the precision the coarse pass
states, and the HBM bandwidth.  A card set below 700 W runs slower; the run
prints the card's limit beside the share.

Scoring work, counted from the benchmark's own reference index for the
queries that reach retrieval, whatever kernel implements it: two operations
(a multiply and an add) per nonzero query weight and real truth title (on
the folded engine per hash: a weight is a query's bucket of one fold map);
bytes: the occupancy bits the weights need, read once per block of
``query_block`` queries (folded: the fold maps' every bucket; exact: the
rows of the block's distinct trigrams, blocks of consecutive queries in the
batch's order).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12,  # float32 as TF32
              "float8_e4m3": 1979e12}
PEAK_BYTES = 3.35e12


def retrieval_work(index, q_tri: np.ndarray, query_block: int) -> Tuple[float, float]:
    """(operations, bytes) of scoring these queries (their trigram lists,
    -1 pad) against ``index`` (``reference.retrieval.ReferenceIndex``)."""
    nt = index.nt
    if len(q_tri) == 0:
        return 0.0, 0.0
    valid = q_tri >= 0
    weighted = valid & (index.idf[np.maximum(q_tri, 0)] > 0)
    n_blocks = -(-len(q_tri) // query_block)
    if index.folded:
        nnz = 0
        for m in index.maps:
            buckets = np.where(weighted, m[np.maximum(q_tri, 0)], -1)
            for row in buckets:
                nnz += len(np.unique(row[row >= 0]))
        bits = n_blocks * len(index.maps) * index.C * nt / 8
        return 2.0 * nnz * nt, float(bits)
    nnz = int(weighted.sum())
    rows = 0
    for s in range(0, len(q_tri), query_block):
        blk = q_tri[s : s + query_block][weighted[s : s + query_block]]
        rows += len(np.unique(blk))
    return 2.0 * nnz * nt, float(rows * nt / 8)


def least_seconds(work: Sequence[Tuple[float, float]], precision: str) -> float:
    """The least time the card needs for every (operations, bytes) given:
    the larger of operations at the peak rate and bytes at the bandwidth."""
    flops = sum(w[0] for w in work)
    nbytes = sum(w[1] for w in work)
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)

