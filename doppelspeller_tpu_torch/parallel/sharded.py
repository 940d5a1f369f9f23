"""Multi-device execution: the title-sharded index and data-parallel boosting.

The JAX package's ``parallel/sharded.py`` in PyTorch.  That package's mesh
is driven by one process (one program over every device, ``shard_map``
inside one ``jit``); so is this one: a ``Mesh`` is a tuple of devices, and
the process queues each shard's work on its device in turn (every
operation on a shard's tensors runs on that card's current stream, and the
kernels' bindings launch on their tensors' card).  A mesh may name one
device more than once: two shards of one card have the shard boundaries,
launches and merges of two cards.

What the mesh buys today is room: an index larger than one card's memory
is held across several.  It costs throughput: on four H100s a predict over
``make_mesh()`` reads 2.2-3.5 times slower than on one card
(``scripts/torch_mesh_cards.py``, which also profiles it): this one host
thread issues every shard's launches, 2.7-3.4 times one card's, while each
card idles most of the predict.

* **Sharded retrieval** (``ShardedJaccardScorer``): the title axis, padded
  to a multiple of ``devices × title_block``, is cut into one run of titles
  per device.  Each shard is the single device's engine over its run (the
  exact engine, kernel A or D; or the folded engine, kernel A with two
  hashes and the exact rescore), and each returns its own top-k.  The
  shards' results go to the mesh's first device and merge by a stable sort
  of the (QB, devices·k) candidates laid out shard by shard: the order of
  ``lax.top_k`` over the JAX package's all-gather, ties to the lower shard.
* **Data-parallel boosting** (``dp_boost_round``, ``models.gbt.train_gbt``
  with ``mesh=``): each shard grows the histograms of its rows in fixed
  point, the integer sums add up on the first device, and every shard
  routes its own rows through the one tree.
* **Row data parallelism** (``replicate``, ``row_parallel``): the fuzzy and
  model stages' engines, one copy per distinct device, each deciding a run
  of rows (``pipeline.Matcher`` under a mesh).
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.device import resolve_device
from doppelspeller_tpu_torch.models.gbt import build_tree_shards, margin_grad_hess, split_rows
from doppelspeller_tpu_torch.ops.fold import FoldedEngine, plan_id_blocks
from doppelspeller_tpu_torch.ops.index_device import build_shard, ids_width, index_from_shards
from doppelspeller_tpu_torch.ops.jaccard import ExactEngine, JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import TruthIndex, checkpoint_holds, plan_query_blocks
from doppelspeller_tpu_torch.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices its shards run on, in shard order (one
    device may appear more than once), and the name of its axis."""

    devices: Tuple[torch.device, ...]
    axis: str = "titles"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        devs = []
        for d in self.devices:
            d = resolve_device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        object.__setattr__(self, "devices", tuple(devs))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """Each device once, in the order of its first shard."""
        return tuple(dict.fromkeys(self.devices))


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


def _merge(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], k: int,
           device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the shards' (scores (QB, k), global positions (QB, k)) on
    ``device``: a stable descending sort of the candidates laid out shard
    by shard, so ties go to the lower shard, then to the shard's own order."""
    vals = torch.cat([v.to(device) for v, _ in parts], dim=1)
    pos = torch.cat([p.to(device) for _, p in parts], dim=1)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(pos, 1, order[:, :k])


class ShardedJaccardScorer(JaccardScorer):
    """Retrieval over a truth index sharded across a mesh's title axis.

    ``truth`` (the encodings) is needed by the folded engine only, which is
    engaged as ``JaccardScorer`` engages it: ``retrieval_mode="folded"``, or
    ``"auto"`` given ``truth`` at ``folded_min_titles`` titles or more.
    ``exact`` / ``folded`` hold one engine per shard (the other is None).
    Results come back on the mesh's first device."""

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
        LOGGER.info("[ShardedJaccardScorer] %d titles on %d shards of %d (tb=%d, %s)",
                    index.num_titles, D, self.ntp_local, self.tb,
                    "folded" if self.folded else "exact")

    def topk_device(self, queries: TitleSet, k: Optional[int] = None,
                    rows: Optional[np.ndarray] = None, probe_tables=None):
        """``JaccardScorer.topk_device`` over the shards, on the mesh's first
        device.  Plans are made over the whole index; each shard scores
        every block and returns its top-k, which merge.  With
        ``probe_tables`` (per-title lengths and longest word lengths on the
        first device) also returns each row's largest of both over its
        candidates, int (R, 2), a padding candidate reading the last title."""
        k = k or self.cfg.top_n_predicting
        if self.index.num_titles < k:
            raise ValueError(f"index has {self.index.num_titles} titles < k={k}")
        per_shard = self.ntp_local if self.folded or not self.cfg.retrieval_window_select \
            else self.ntp_local // max(self.tb // 128, 1)
        if per_shard < k:
            raise ValueError(f"per-shard candidates {per_shard} < k={k}; use fewer devices or "
                             "a larger title_block")
        vals: List[torch.Tensor] = []
        pos: List[torch.Tensor] = []
        if self.exact is not None:
            for p in plan_query_blocks(queries, self.index, self.cfg, rows=rows):
                self.exact[0].check_plan(p)
                uid = {d: torch.from_numpy(p.union_ids).to(d) for d in self.mesh.distinct}
                wp = {d: torch.from_numpy(p.w_pos).to(d) for d in self.mesh.distinct}
                parts = []
                for eng, lo, d in zip(self.exact, self.offsets, self.mesh.devices):
                    v, ps = eng.topk_union(uid[d], wp[d], k)
                    parts.append((v, ps + lo))
                v, ps = _merge(parts, k, self.device)
                vals.append(v[: p.n_valid])
                pos.append(ps[: p.n_valid])
        else:
            plans = plan_id_blocks(queries, self.cfg, rows=rows)
            if plans:
                ids_np = np.concatenate([p.ids for p in plans])
                ids = {d: torch.from_numpy(ids_np).to(d).to(torch.int64) for d in self.mesh.distinct}
                qb = plans[0].ids.shape[0]
                for j, p in enumerate(plans):
                    parts = []
                    for eng, lo, d in zip(self.folded, self.offsets, self.mesh.devices):
                        v, ps = eng.topk_block(ids[d][j * qb : (j + 1) * qb], k)
                        parts.append((v, ps + lo))
                    v, ps = _merge(parts, k, self.device)
                    vals.append(v[: p.n_valid])
                    pos.append(ps[: p.n_valid])
        if vals:
            out = torch.cat(vals), torch.cat(pos)
        else:
            empty = torch.zeros((0, k), device=self.device)
            out = empty, empty.to(torch.int32)
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


# --------------------------------------------------- row data parallelism

def replicate(module: nn.Module, mesh: Mesh) -> Dict[torch.device, nn.Module]:
    """One copy of ``module`` (its buffers) on each distinct device of
    ``mesh``: ``module`` itself, which lies on the mesh's first device, for
    that one.  Two shards of one card share its copy."""
    out = {}
    for d in mesh.distinct:
        if d == mesh.devices[0]:
            out[d] = module
        else:
            rep = copy.deepcopy(module).to(d)
            rep.device = d
            out[d] = rep
    return out


def row_parallel(mesh: Mesh, run: Callable[..., Tuple[torch.Tensor, ...]],
                 *rows: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``run(device, *row slices)`` on each shard's run of rows (⌈R/D⌉ rows
    each, in order, moved to the shard's device; a shard left with none
    is skipped), each output's parts concatenated on the mesh's first
    device in row order.  Every row must be decided alone, so that the
    result is the single device's."""
    n = rows[0].shape[0]
    per = max(-(-n // mesh.size), 1)
    outs = []
    for i, d in enumerate(mesh.devices):
        lo = i * per
        if lo >= n and outs:
            break
        outs.append(run(d, *(x[lo : lo + per].to(d) for x in rows)))
    first = mesh.devices[0]
    return tuple(torch.cat([o[j].to(first) for o in outs]) for j in range(len(outs[0])))
