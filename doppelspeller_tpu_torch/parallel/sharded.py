"""Multi-device execution: the title-sharded index and data-parallel boosting.

The JAX package's ``parallel/sharded.py`` in PyTorch.  That package's mesh
is one SPMD program per group of query blocks (``shard_map`` inside one
``jit``), so every shard works at once.  Here a ``Mesh`` is a tuple of
devices and one process drives it through ``Workers``
(``parallel/workers.py``, which drives the single device too, as a mesh of
one shard): one host thread per distinct device, each issuing its shards'
work under that device, on a stream per shard.  The shards of distinct
cards are issued at once, two shards of one card run on two streams, and
the caller's stream waits on the shards' events, never on the host.  A
mesh may name one device more than once: two shards of one card have the
shard boundaries, streams, launches and merges of two cards.

What the mesh buys is room: an index larger than one card's memory is
held across several.  On one card it buys no speed: the single card
issues its predict as the mesh does (retrieval groups, the fuzzy and
model stages as graphs), and two shards of one H100 80GB HBM3 at 700 W
take 0.89–1.02× its time (``chip_smoke.py``'s ``mesh`` phase, in turns).
On four such cards (``scripts/torch_mesh_cards.py``) a predict over
``make_mesh()`` ran at 1.75× one card's queries a second at 150k titles
and 2.25× at 500k, against a single card that still ran its fuzzy and
model stages op by op.

* **Sharded retrieval** (``ShardedJaccardScorer``): the title axis, padded
  to a multiple of ``devices × title_block``, is cut into one run of titles
  per device.  Each shard is the single device's engine over its run (the
  exact engine, kernel A or D; or the folded engine, kernel A with two
  hashes and the exact rescore), and each returns its own top-k.  The
  blocks go in groups of ``dispatch_blocks`` (of ``query_block`` queries;
  the JAX package's groups): a group's inputs are uploaded once a card
  from pinned memory, every shard scores each block of the group on its
  own stream, and the shards' candidates of the whole group go to the
  first device once and merge there in one stable sort of the (G, QB,
  devices·k) candidates laid out shard by shard: the order of
  ``lax.top_k`` over the JAX package's all-gather, ties to the lower shard.
  On a card each (shard, k, block shape) is a CUDA graph, captured in
  the second run that uses it (``Workers.run``; op by op before) at its
  first block (that block's result the op-by-op warm-up's) while every
  worker is idle, and replayed after that: a block costs its shard one
  copy in, one replay and one copy out.
* **Data-parallel boosting** (``dp_boost_round``, ``models.gbt.train_gbt``
  with ``mesh=``): each shard grows the histograms of its rows in fixed
  point, the integer sums add up on the first device, and every shard
  routes its own rows through the one tree.
* **Row data parallelism** (``parallel/workers.py``'s ``replicate`` and
  ``row_parallel``): the fuzzy and model stages' engines, one copy per
  distinct device, each deciding a run of rows on its shard's worker
  (``pipeline.Matcher``).  On a card each shard's run, padded to a power
  of two rows, is a CUDA graph too (the fuzzy stage in its static form,
  which makes no host sync and decides the same): these stages are
  thousands of small operations a slab, and op by op the workers'
  launches contend for the interpreter lock, each switch costing more
  than the launch itself.

An exception on a worker is raised in the caller as ``ShardError``, which
names the shard and its device; there is no serial path beside the
workers.  ``Workers.use_graphs = False`` runs every step op by op (the
reference the graphs are held to).  A CPU mesh (the tests') takes the
same workers and groups, each step a direct call.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.models.gbt import build_tree_shards, margin_grad_hess, split_rows
from doppelspeller_tpu_torch.ops.fold import FoldedEngine
from doppelspeller_tpu_torch.ops.index_device import build_shard, ids_width, index_from_shards
from doppelspeller_tpu_torch.ops.jaccard import ExactEngine, JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import TruthIndex, checkpoint_holds
from doppelspeller_tpu_torch.parallel.workers import (  # noqa: F401  (re-exported)
    Mesh,
    ShardError,
    Workers,
    replicate,
    row_parallel,
)
from doppelspeller_tpu_torch.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)


def make_mesh(n_devices: Optional[int] = None, axis: str = "titles",
              platform: Optional[str] = None) -> Mesh:
    """The first ``n_devices`` cards (default: all of them) as a mesh;
    ``platform="cpu"`` gives ``n_devices`` (default 1) CPU entries, the
    counterpart of the JAX package's virtual CPU devices.  ValueError where
    there are fewer cards than asked for."""
    if platform == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1), axis)
    if platform not in (None, "cuda"):
        raise ValueError(f"unknown platform {platform!r}: 'cuda' or 'cpu'")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or max(have, 1)
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


# ------------------------------------------------------------ sharded index

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _title_slice(truth: TitleSet, lo: int, hi: int) -> TitleSet:
    return TitleSet(titles=truth.titles[lo:hi], transformed=truth.transformed[lo:hi],
                    ids=truth.ids[lo:hi], encoded=truth.encoded[lo:hi], lengths=truth.lengths[lo:hi])


def _shard_view(index: TruthIndex, lo: int, ntp_local: int) -> TruthIndex:
    """Titles [lo, lo + ntp_local) of ``index`` as an index of their own:
    their trigram rows, ids and sums (zero past the real titles), the
    global IDF tables."""
    nt = int(np.clip(index.num_titles - lo, 0, ntp_local))
    sums = np.zeros(ntp_local, np.float32)
    part = index.sums[lo : lo + ntp_local]
    sums[: len(part)] = part
    return replace(index, sums=sums, title_ids=index.title_ids[lo : lo + nt], num_titles=nt,
                   padded_titles=ntp_local, trigrams=index.trigrams[lo : lo + nt])


class ShardedJaccardScorer(JaccardScorer):
    """Retrieval over a truth index sharded across a mesh's title axis.

    ``truth`` (the encodings) is needed by the folded engine only, which is
    engaged as ``JaccardScorer`` engages it: ``retrieval_mode="folded"``, or
    ``"auto"`` given ``truth`` at ``folded_min_titles`` titles or more.
    ``exact`` / ``folded`` hold one engine per shard (the other is None).
    Results come back on the mesh's first device.  ``workers`` issue the
    shards' work and hold their CUDA graphs (``close`` ends their
    threads)."""

    def __init__(self, index: TruthIndex, mesh: Mesh, config: Config,
                 truth: Optional[TitleSet] = None):
        self.cfg = config
        self.index = index
        self.mesh = mesh
        self.device = mesh.devices[0]
        D = mesh.size
        # pad the title axis to a multiple of (devices × title_block)
        self.ntp = _round_up(index.padded_titles, D * config.title_block)
        self.ntp_local = self.ntp // D
        self.offsets = [i * self.ntp_local for i in range(D)]
        self.tb = 2048 if self.ntp_local % 2048 == 0 else config.title_block
        if self._wants_folded(index, config, truth):
            # the trigram lists' width is that of all the titles
            l_eff = int(truth.lengths.max(initial=3)) if len(truth) else 3
            ltw = max(_round_up(l_eff - 2, 8), 8)
            self.folded = [
                FoldedEngine(_shard_view(index, lo, self.ntp_local),
                             _title_slice(truth, lo, lo + self.ntp_local), config, dev,
                             tb=self.tb, ltw=ltw)
                for lo, dev in zip(self.offsets, mesh.devices)]
            self.exact = None
        else:
            self.folded = None
            self.exact = [ExactEngine(_shard_view(index, lo, self.ntp_local), config, dev, tb=self.tb)
                          for lo, dev in zip(self.offsets, mesh.devices)]
        self.workers = Workers(mesh)
        LOGGER.info("[ShardedJaccardScorer] %d titles on %d shards of %d (tb=%d, %s)",
                    index.num_titles, D, self.ntp_local, self.tb,
                    "folded" if self.folded else "exact")

    def engine(self, i: int):
        """Shard i's engine."""
        return (self.exact if self.exact is not None else self.folded)[i]

    def _merge(self, plans, futures: List[Future], k: int, vals: list, pos: list) -> None:
        """A group's candidates of every shard, on the first device, merged
        by one stable descending sort of (G, QB, devices·k) laid out shard
        by shard (ties to the lower shard, then to the shard's own order);
        each block's valid rows appended to ``vals`` and ``pos``."""
        done = self.workers.collect(futures)
        parts = self.workers.to_first([done[i] for i in range(self.mesh.size)])
        x = torch.stack([p[0] for p in parts], dim=2)                 # (G, QB, D, 2k)
        G, qb, D, _ = x.shape
        v = x[..., :k].reshape(G, qb, D * k).view(torch.float32)
        ps = x[..., k:].reshape(G, qb, D * k)
        v, order = torch.sort(v, dim=2, descending=True, stable=True)
        ps = torch.gather(ps, 2, order[..., :k])
        for j, p in enumerate(plans):
            vals.append(v[j, : p.n_valid, :k])
            pos.append(ps[j, : p.n_valid])

    def _check_k(self, k: int) -> None:
        super()._check_k(k)
        per_shard = self.ntp_local if self.folded or not self.cfg.retrieval_window_select \
            else self.ntp_local // max(self.tb // 128, 1)
        if per_shard < k:
            raise ValueError(f"per-shard candidates {per_shard} < k={k}; use fewer devices or "
                             "a larger title_block")

    def topk_device(self, queries: TitleSet, k: Optional[int] = None,
                    rows: Optional[np.ndarray] = None, probe_tables=None):
        """``JaccardScorer.topk_device`` over the shards, on the mesh's first
        device, on the caller's stream.  Plans are made over the whole
        index and go in groups of ``dispatch_blocks`` (of ``query_block``
        queries); each shard scores every block and returns its top-k,
        which merge once a group.  With ``probe_tables`` (per-title
        lengths and longest word lengths on the first device) also returns
        each row's largest of both over its candidates, int (R, 2), a
        padding candidate reading the last title."""
        out = super().topk_device(queries, k, rows)
        if probe_tables is None:
            return out
        t_len, t_wlen = probe_tables
        cand = out[1].to(torch.int64).clamp(max=t_len.shape[0] - 1)
        probe = torch.stack([t_len[cand].max(dim=1).values, t_wlen[cand].max(dim=1).values], dim=1) \
            if len(cand) else torch.zeros((0, 2), dtype=t_len.dtype, device=self.device)
        return out + (probe,)

    # ------------------------------------------------- checkpoint / resume

    def save(self, path: str) -> None:
        """Checkpoint the index under the package's ``INDEX_FORMAT``: the
        statistics and the per-title trigram rows, which shard by rows, so
        one file loads onto a mesh of any size or onto one device
        (``TruthIndex.load``).  The packed shards are never on the host:
        each device builds its own from its rows."""
        self.index.save(path)

    @classmethod
    def load(cls, path: str, mesh: Mesh, config: Config,
             truth: Optional[TitleSet] = None) -> "ShardedJaccardScorer":
        """A checkpoint of ``save`` (or ``TruthIndex.save``) placed shard by
        shard onto ``mesh``; ``truth`` lets ``retrieval_mode`` engage the
        folded engine, whose state is never checkpointed."""
        scorer = cls(TruthIndex.load(path), mesh, config, truth=truth)
        LOGGER.info("[ShardedJaccardScorer] loaded checkpoint %s onto %d shards", path, mesh.size)
        return scorer

    @staticmethod
    def checkpoint_matches(path: str, truth: TitleSet) -> bool:
        """Whether the checkpoint at ``path`` is this package's and holds
        exactly ``truth`` (``ngram_index.checkpoint_holds``).  A foreign
        (the JAX package's) or unreadable file does not match, with a
        warning."""
        try:
            return checkpoint_holds(path, truth)
        except Exception as exc:  # a torn or foreign file: rebuild rather than fail
            LOGGER.warning("index checkpoint at %s unreadable (%s)", path, exc)
            return False


def build_sharded_index(truth: TitleSet, mesh: Mesh, config: Config) -> ShardedJaccardScorer:
    """The truth index and its scorer, built on ``mesh``: each shard's ids,
    document frequencies and sums on its own device from its slice of the
    encodings (``index_device.build_shard``, ``shard_sums``), the
    frequencies summed on the first device.  The ids are dropped once the
    index is downloaded; each shard's engine builds its matrices on its
    device as ``ShardedJaccardScorer`` does.  ``.index`` equals
    ``build_truth_index``'s bit for bit; its ids keep the width of all the
    titles."""
    nt, tb, D = len(truth), config.title_block, mesh.size
    ntp_local = _round_up(_round_up(max(nt, tb), tb), D * tb) // D
    width = ids_width(truth.lengths)
    shards = [build_shard(truth.encoded[lo : lo + ntp_local], truth.lengths[lo : lo + ntp_local],
                          dev, width)
              for lo, dev in zip(range(0, D * ntp_local, ntp_local), mesh.devices)]
    index = index_from_shards(truth, config, shards)
    del shards
    return ShardedJaccardScorer(index, mesh, config, truth=truth)


# ------------------------------------------------------- data-parallel GBT

def dp_boost_round(mesh: Mesh, bins: Sequence[torch.Tensor], y: Sequence[torch.Tensor],
                   margins: Sequence[torch.Tensor], *, depth: int, eta: float, beta: float,
                   lambda_: float = 1.0, min_child_weight: float = 1.0):
    """One data-parallel boosting round: ``bins[i]`` (N_i, F), ``y[i]`` and
    ``margins[i]`` (N_i,) on ``mesh.devices[i]``.  Returns (each shard's new
    margins, the tree (feat, split_bin, missing_left, value·eta, is_leaf) on
    the first device): one device's round over all the rows, bit for bit."""
    if not len(bins) == len(y) == len(margins) == mesh.size:
        raise ValueError(f"one shard per device of the mesh ({mesh.size}), got {len(bins)}")
    first = mesh.devices[0]
    # the gradients of all rows at once, as ``boost_segment`` takes them
    g, h = margin_grad_hess(torch.cat([m.to(first) for m in margins]),
                            torch.cat([t.to(first) for t in y]), beta)
    *tree, contrib = build_tree_shards(bins, split_rows(g, bins), split_rows(h, bins), depth=depth,
                                       lambda_=lambda_, min_child_weight=min_child_weight)
    tree[3] = tree[3] * eta
    return [m + eta * c for m, c in zip(margins, contrib)], tuple(tree)


