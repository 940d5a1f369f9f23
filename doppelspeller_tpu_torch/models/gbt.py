"""Gradient-boosted trees: training and inference.

The JAX package's ``models/gbt.py`` in PyTorch, on one device: the card
unless the caller names the CPU.

* Histogram tree growth, level-wise, 256 bins per feature (bin 255 holds
  the missing values), with XGBoost's missing-value handling: at every
  split the missing mass is tried on both sides and the better direction
  is kept.
* The custom objective and metric: weighted log loss
  g = p(β + y − βy) − y,  h = p(1 − p)(β + y − βy)  on p = sigmoid(margin),
  and the custom error FN + β·FP at the probability threshold.
* Early stopping on the eval custom error with ``best_ntree_limit``.

Data-parallel on a mesh (``train_gbt(mesh=)``, ``build_tree_shards``):
each shard holds the bins of some rows, grows their histograms and routes
them; the histograms add up on the first device, where the split is
chosen once.

One arithmetic on both devices: the level histograms are sums of ``g``
and ``h`` over the key (node, feature, bin), formed with ``index_add_`` in
fixed point (int64 multiples of 2^-s, s chosen per tree from the largest
``|g|`` or ``|h|`` so that no sum can overflow), so they do not depend on
the order of the adds: the card's atomics give the CPU's sums, and two
trainings on the card give the same trees bit for bit.  Each sum rounds
once, to f32, where the reference's f32 segment sums round at every add.
The last level's leaf sums take ``g`` and ``h`` rounded to bf16, as the
reference does on every path.  The bins' totals and prefix sums are one
``sum`` and one ``cumsum`` in f32, whose order on either device is fixed.
Routing is plain indexing.  Train and eval
rows share one sample axis under {0, 1} masks; every row is routed through
each new tree and its margin is updated from the leaf it reaches, so no
round walks the forest.

Inference reads ``model.npz`` of either package with the reference's
semantics: at an internal node a NaN feature goes the node's missing
direction, otherwise left when ``x <= threshold``; a node is a leaf when
``is_leaf`` or ``feat < 0``.  The walk is ``depth`` gathers over
(batch, tree).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.device import resolve_device

LOGGER = logging.getLogger(__name__)

NB = 256          # bins per feature (255 = missing)
MISSING_BIN = 255
N_EDGES = NB - 2  # 254 cut points -> value bins 0..254

# rounds per boosting segment: the error histories and the trees come to the
# host once per segment, and early stopping is checked there
SEGMENT_ROUNDS = 50


@dataclass
class GBTParams:
    depth: int = 5
    eta: float = 0.1
    lambda_: float = 1.0
    min_child_weight: float = 1.0
    num_boost_round: int = 1000
    early_stopping_rounds: int = 50
    beta: float = 5.0                     # false-positive penalty factor
    threshold: float = 0.9                # custom-error probability threshold
    base_score: float = 0.5
    seed: int = 0

    @classmethod
    def from_config(cls, cfg: Config) -> "GBTParams":
        return cls(
            depth=cfg.gbt_max_depth,
            eta=cfg.gbt_eta,
            lambda_=cfg.gbt_lambda,
            min_child_weight=cfg.gbt_min_child_weight,
            num_boost_round=cfg.gbt_num_boost_round,
            early_stopping_rounds=cfg.gbt_early_stopping_rounds,
            beta=cfg.false_positive_penalty_factor,
            threshold=cfg.prediction_probability_threshold,
            seed=cfg.seed,
        )


# ----------------------------------------------------------------- objective

def weighted_log_loss_grad_hess(pred: torch.Tensor, y: torch.Tensor,
                                beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient and hessian of the β-weighted log loss at probability ``pred``."""
    w = beta + y - beta * y
    g = pred * w - y
    h = pred * (1.0 - pred) * w
    return g, h


def margin_grad_hess(margin: torch.Tensor, y: torch.Tensor,
                     beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """grad/hess w.r.t. the raw margin: p = sigmoid(margin)."""
    return weighted_log_loss_grad_hess(torch.sigmoid(margin), y, beta)


def custom_error(pred: np.ndarray, y: np.ndarray, beta: float, threshold: float) -> float:
    """FN + beta*FP at the probability threshold."""
    pos = pred > threshold
    fn = float(y[~pos].sum())
    fp = float((y[pos] == 0).sum()) * beta
    return fn + fp


def auc_score(pred: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(pred, kind="stable")
    ranks = np.empty(len(pred), dtype=np.float64)
    ranks[order] = np.arange(1, len(pred) + 1)
    # average ranks over ties
    sorted_pred = pred[order]
    _uniq, inv, cnt = np.unique(sorted_pred, return_inverse=True, return_counts=True)
    csum = np.cumsum(cnt)
    avg_rank = (csum - (cnt - 1) / 2.0).astype(np.float64)
    ranks[order] = avg_rank[inv]
    n_pos = float(y.sum())
    n_neg = float(len(y) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return (ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


# ------------------------------------------------------------------- binning

def compute_bin_edges(X: np.ndarray) -> np.ndarray:
    """float32[F, N_EDGES] quantile cut points per feature (NaN-aware)."""
    F = X.shape[1]
    edges = np.zeros((F, N_EDGES), dtype=np.float32)
    qs = np.linspace(0.0, 1.0, NB)[1:-1]  # 254 interior quantiles
    for f in range(F):
        col = X[:, f]
        col = col[~np.isnan(col)]
        if len(col) == 0:
            edges[f] = np.arange(N_EDGES, dtype=np.float32)
            continue
        edges[f] = np.quantile(col, qs).astype(np.float32)
    return edges


def bin_features(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """uint8[N, F] bin codes; NaN → MISSING_BIN.  bin = Σ_j (x > e_j)."""
    N, F = X.shape
    out = np.zeros((N, F), dtype=np.uint8)
    for f in range(F):
        col = X[:, f]
        nan = np.isnan(col)
        b = np.searchsorted(edges[f], col, side="left")
        b = np.clip(b, 0, N_EDGES)  # values above the last edge → bin 254
        b[nan] = MISSING_BIN
        out[:, f] = b.astype(np.uint8)
    return out


# ------------------------------------------------------------- tree growth

# fixed-point histograms: every sum stays below 2^FIXED_POINT_BITS in int64,
# and a value keeps at least MIN_FIXED_POINT_SHIFT bits after its binary point
FIXED_POINT_BITS = 62
MIN_FIXED_POINT_SHIFT = 24


def fixed_point_shift(max_abs: torch.Tensor, n_keys: int) -> torch.Tensor:
    """The largest s with ``n_keys · max_abs · 2^s < 2^62`` for a float32
    scalar ``max_abs`` (at most 100, so that 2^-s stays a normal f32).
    Rounding the product in f32 only lowers s: it never falls below a power
    of two it lies above."""
    _, e = torch.frexp(max_abs * n_keys)
    return (FIXED_POINT_BITS - e).clamp(max=100)


def _quantize(vs: Sequence[torch.Tensor], n_keys: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(int64 round(v · 2^s) of each shard's ``v``, 2^-s on the first
    shard's device) for ``fixed_point_shift(max |v| over every shard,
    n_keys)``: any ``n_keys`` of the integers add up without overflow, and
    every shard (one device's values are one shard) quantizes alike."""
    first = vs[0].device
    top = torch.stack([v.abs().max().to(first) for v in vs if v.numel()]).max()
    s = fixed_point_shift(top, n_keys).to(torch.float32)
    return [torch.round(v * torch.exp2(s.to(v.device))).to(torch.int64) for v in vs], torch.exp2(-s)


def _segment_sum(keys: Sequence[torch.Tensor], qs: Sequence[torch.Tensor], unit: torch.Tensor,
                 n_segments: int) -> torch.Tensor:
    """float32[n_segments] sums of the fixed-point values ``qs[i]`` int64
    (M_i,) by ``keys[i]`` (M_i,) over every shard i, times ``unit``, on the
    first shard's device.  Integer addition is exact in any order, so the
    card's atomics give the CPU's sums and the shards' sums add up to one
    device's: each sum rounds once, to f32."""
    first = qs[0].device
    total = None
    for key, q in zip(keys, qs):
        part = torch.zeros(n_segments, dtype=torch.int64, device=q.device).index_add_(0, key, q)
        total = part.to(first) if total is None else total + part.to(first)
    return total.to(torch.float32) * unit


def build_tree(
    bins: torch.Tensor,   # integer [N, F] bin codes
    g: torch.Tensor,      # float32[N]
    h: torch.Tensor,      # float32[N]
    *,
    depth: int,
    lambda_: float,
    min_child_weight: float,
):
    """Grow one depth-``depth`` tree level-wise.  Returns heap arrays of
    size 2^(depth+1) − 1 on the inputs' device, (feat int32, split_bin
    int32, missing_left bool, value float32, is_leaf bool), and ``contrib``
    float32[N], the value of the leaf each sample reaches (unscaled by eta).

    Per level the (node, feature, bin) sums of ``g`` and ``h`` are one
    segment sum over N·F keys; the split search is a cumulative sum
    (``torch.cumsum``) over the 255 value bins for all (node, feature) pairs at once, with the
    missing mass tried left and right; the best split is the first maximum
    over (feature, edge, missing-left before missing-right).  Rows with
    g = h = 0 (eval rows) are routed and add nothing to any sum."""
    *tree, (contrib,) = build_tree_shards([bins], [g], [h], depth=depth, lambda_=lambda_,
                                          min_child_weight=min_child_weight)
    return (*tree, contrib)


def build_tree_shards(
    bins: Sequence[torch.Tensor],
    g: Sequence[torch.Tensor],
    h: Sequence[torch.Tensor],
    *,
    depth: int,
    lambda_: float,
    min_child_weight: float,
    n_rows: Optional[int] = None,
):
    """``build_tree`` over rows split into shards: ``bins[i]`` (N_i, F),
    ``g[i]``, ``h[i]`` (N_i,) on one device each (a mesh's data-parallel
    boosting).  Each shard sums its own rows' histograms in fixed point; the
    sums add up on the first shard's device, where the split is chosen once,
    and each shard routes its own rows.  Returns the tree on the first
    shard's device and the list of each shard's ``contrib``.

    ``n_rows`` (default: every shard's rows) sets the fixed-point shift with
    the largest ``|g|`` and ``|h|`` of all shards.  A caller that pads
    shards with rows of g = h = 0 passes the unpadded count, so that the
    shift, and with it every sum, is bit for bit that of one device holding
    the unpadded rows."""
    first = bins[0].device
    F = bins[0].shape[1]
    n = sum(b.shape[0] for b in bins) if n_rows is None else n_rows
    n_heap = 2 ** (depth + 1) - 1

    bins_i = [b.to(torch.int64) for b in bins]
    # key of a row's bin within one node's histogram: f·NB + bin
    fb = [b + torch.arange(F, device=b.device, dtype=torch.int64)[None, :] * NB for b in bins_i]
    rows = [torch.arange(b.shape[0], device=b.device) for b in bins]

    feat = torch.full((n_heap,), -1, dtype=torch.int32, device=first)
    split_bin = torch.zeros((n_heap,), dtype=torch.int32, device=first)
    missing_left = torch.zeros((n_heap,), dtype=torch.bool, device=first)
    value = torch.zeros((n_heap,), dtype=torch.float32, device=first)
    is_leaf = torch.zeros((n_heap,), dtype=torch.bool, device=first)

    # heap position per sample, whether it sits at a final leaf, its leaf value
    node = [torch.zeros((b.shape[0],), dtype=torch.int64, device=b.device) for b in bins]
    done = [torch.zeros((b.shape[0],), dtype=torch.bool, device=b.device) for b in bins]
    contrib = [torch.zeros((b.shape[0],), dtype=torch.float32, device=b.device) for b in bins]
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=first)
    # every level's keys: N·F values, the done rows' all in one spare slot
    gq, g_unit = _quantize(g, n * F)
    hq, h_unit = _quantize(h, n * F)

    for level in range(depth):
        n_nodes = 2 ** level
        offset = n_nodes - 1
        S = n_nodes * F * NB
        keys = []
        local = []
        for j in range(len(bins)):
            # done rows hold no live local id: their keys go to the spare slot S
            local.append(torch.where(done[j], 0, node[j] - offset))
            keys.append(torch.where(done[j][:, None], S, local[j][:, None] * (F * NB) + fb[j]).reshape(-1))
        G = _segment_sum(keys, [q[:, None].expand(-1, F).reshape(-1) for q in gq], g_unit, S + 1)[:S]
        H = _segment_sum(keys, [q[:, None].expand(-1, F).reshape(-1) for q in hq], h_unit, S + 1)[:S]
        G, H = G.reshape(n_nodes, F, NB), H.reshape(n_nodes, F, NB)

        Gm, Hm = G[..., MISSING_BIN], H[..., MISSING_BIN]
        Gv, Hv = G[..., :MISSING_BIN], H[..., :MISSING_BIN]
        Gtot = Gv.sum(dim=-1) + Gm                # (nodes, F), the same for all f
        Htot = Hv.sum(dim=-1) + Hm
        GL = torch.cumsum(Gv, dim=-1)[..., :N_EDGES]      # split at k: bins ≤ k left
        HL = torch.cumsum(Hv, dim=-1)[..., :N_EDGES]
        parent = (Gtot * Gtot / (Htot + lambda_))[..., None]

        def gain_of(GLx, HLx):
            GRx = Gtot[..., None] - GLx
            HRx = Htot[..., None] - HLx
            ok = (HLx >= min_child_weight) & (HRx >= min_child_weight)
            gn = GLx * GLx / (HLx + lambda_) + GRx * GRx / (HRx + lambda_) - parent
            return torch.where(ok, gn, neg_inf)

        gain_ml = gain_of(GL + Gm[..., None], HL + Hm[..., None])  # missing left
        gain_mr = gain_of(GL, HL)                                   # missing right
        gflat = torch.stack([gain_ml, gain_mr], dim=-1).reshape(n_nodes, -1)
        best = torch.argmax(gflat, dim=1)                           # first max
        best_gain = torch.gather(gflat, 1, best[:, None])[:, 0]
        best_f = best // (N_EDGES * 2)
        best_k = (best // 2) % N_EDGES
        best_ml = (best % 2) == 0

        node_value = -Gtot[:, 0] / (Htot[:, 0] + lambda_)
        # leaf if no valid positive-gain split or the node is empty
        leaf_now = (best_gain <= 1e-10) | (Htot[:, 0] <= 0.0)

        sl = slice(offset, offset + n_nodes)
        feat[sl] = torch.where(leaf_now, -1, best_f).to(torch.int32)
        split_bin[sl] = best_k.to(torch.int32)
        missing_left[sl] = best_ml
        value[sl] = node_value
        is_leaf[sl] = leaf_now

        # each shard routes its own samples
        for j in range(len(bins)):
            dev = bins[j].device
            bf, bk, bml, lf, nv = (x.to(dev) for x in (best_f, best_k, best_ml, leaf_now, node_value))
            lj = local[j]
            b = bins_i[j][rows[j], bf[lj]]
            go_left = torch.where(b == MISSING_BIN, bml[lj], b <= bk[lj])
            newly_done = ~done[j] & lf[lj]
            contrib[j] = contrib[j] + torch.where(newly_done, nv[lj], 0.0)
            done[j] = done[j] | newly_done
            # a row that became a leaf here stays at offset + local, its own node
            node[j] = torch.where(done[j], node[j], 2 * node[j] + 1 + (~go_left).to(torch.int64))

    # final level: everything still active becomes a leaf; its sums take g
    # and h rounded to bf16, as the reference's do on every path
    n_nodes = 2 ** depth
    offset = n_nodes - 1
    local = [torch.where(d, n_nodes, nd - offset) for d, nd in zip(done, node)]
    gb, g_unit = _quantize([x.to(torch.bfloat16).to(torch.float32) for x in g], n)
    hb, h_unit = _quantize([x.to(torch.bfloat16).to(torch.float32) for x in h], n)
    Gn = _segment_sum(local, gb, g_unit, n_nodes + 1)[:n_nodes]
    Hn = _segment_sum(local, hb, h_unit, n_nodes + 1)[:n_nodes]
    leaf_val = -Gn / (Hn + lambda_)
    for j in range(len(bins)):
        lv = leaf_val.to(bins[j].device)
        contrib[j] = contrib[j] + torch.where(done[j], 0.0, lv[local[j].clamp(max=n_nodes - 1)])
    value[offset:] = leaf_val
    is_leaf[offset:] = True
    return feat, split_bin, missing_left, value, is_leaf, contrib


# -------------------------------------------------------------------- model

@dataclass
class GBTModel:
    feat: np.ndarray          # int32[T, n_heap]
    threshold: np.ndarray     # float32[T, n_heap] raw-value split thresholds
    split_bin: np.ndarray     # int32[T, n_heap]
    missing_left: np.ndarray  # bool[T, n_heap]
    value: np.ndarray         # float32[T, n_heap] (eta-scaled)
    is_leaf: np.ndarray       # bool[T, n_heap]
    edges: np.ndarray         # float32[F, N_EDGES]
    base_score: float
    best_ntree_limit: int
    depth: int
    history: dict = field(default_factory=dict)

    @property
    def num_trees(self) -> int:
        return self.feat.shape[0]

    @classmethod
    def from_arrays(cls, arrays: Dict[str, object]) -> "GBTModel":
        """Build from a mapping of the model's fields (numpy arrays and
        scalars), e.g. a loaded ``model.npz`` or a JAX ``GBTModel``'s
        ``__dict__``; ``history`` may be absent."""
        return cls(
            feat=np.asarray(arrays["feat"], dtype=np.int32),
            threshold=np.asarray(arrays["threshold"], dtype=np.float32),
            split_bin=np.asarray(arrays["split_bin"], dtype=np.int32),
            missing_left=np.asarray(arrays["missing_left"], dtype=bool),
            value=np.asarray(arrays["value"], dtype=np.float32),
            is_leaf=np.asarray(arrays["is_leaf"], dtype=bool),
            edges=np.asarray(arrays["edges"], dtype=np.float32),
            base_score=float(arrays["base_score"]),
            best_ntree_limit=int(arrays["best_ntree_limit"]),
            depth=int(arrays["depth"]),
            history=dict(arrays.get("history") or {}),
        )

    @classmethod
    def load(cls, path: str) -> "GBTModel":
        with np.load(path) as z:
            return cls.from_arrays({k: z[k] for k in z.files})

    def save(self, path: str) -> None:
        """The JAX package's ``model.npz`` keys, so each package reads the
        other's file."""
        np.savez_compressed(
            path,
            feat=self.feat, threshold=self.threshold, split_bin=self.split_bin,
            missing_left=self.missing_left, value=self.value, is_leaf=self.is_leaf,
            edges=self.edges,
            base_score=np.float32(self.base_score),
            best_ntree_limit=np.int64(self.best_ntree_limit),
            depth=np.int64(self.depth),
        )

    def predict(self, X: np.ndarray, ntree_limit: Optional[int] = None,
                batch: int = 262144, device="cuda") -> np.ndarray:
        """Probabilities float32[len(X)] = sigmoid(margin) over the first
        ``ntree_limit`` (default ``best_ntree_limit``) trees."""
        dev = resolve_device(device)
        nt = ntree_limit or self.best_ntree_limit or self.num_trees
        nt = min(nt, self.num_trees)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[:nt])).to(dev)

        feat, thr, ml, val, leaf = (put(self.feat).to(torch.int64), put(self.threshold),
                                    put(self.missing_left), put(self.value), put(self.is_leaf))
        # the walk holds (rows, trees, internal nodes) temporaries
        step = max(1, min(batch, (1 << 26) // max(nt * (2 ** self.depth - 1), 1)))
        out = np.zeros(len(X), dtype=np.float32)
        for s in range(0, len(X), step):
            xb = torch.from_numpy(np.ascontiguousarray(X[s : s + step], dtype=np.float32)).to(dev)
            m = predict_forest_margin(xb, feat, thr, ml, val, leaf, self.depth, self.base_margin)
            out[s : s + len(xb)] = torch.sigmoid(m).cpu().numpy()
        return out

    def feature_importance(self) -> np.ndarray:
        """Split counts per feature, normalized."""
        nt = self.best_ntree_limit or self.num_trees
        used = self.feat[:nt]
        counts = np.zeros(self.edges.shape[0], dtype=np.float64)
        valid = (used >= 0) & ~self.is_leaf[:nt]
        np.add.at(counts, used[valid], 1.0)
        total = counts.sum()
        return counts / total if total > 0 else counts

    def forest_arrays(self, device, pad_to: int = 64):
        """(feat, threshold, missing_left, value, is_leaf) tensors of the
        first ``best_ntree_limit`` trees on ``device``, padded to a multiple
        of ``pad_to`` trees with single-leaf trees of value 0."""
        nt = self.best_ntree_limit or self.num_trees
        n_pad = max(((nt + pad_to - 1) // pad_to) * pad_to - nt, 0)

        def pad(a: np.ndarray, leaf_like: bool) -> torch.Tensor:
            a = a[:nt]
            if n_pad:
                extra = np.zeros((n_pad,) + a.shape[1:], a.dtype)
                if leaf_like:
                    extra[:, 0] = 1
                a = np.concatenate([a, extra])
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return (pad(self.feat, False).to(torch.int64), pad(self.threshold, False),
                pad(self.missing_left, False), pad(self.value, False),
                pad(self.is_leaf, True))

    @property
    def base_margin(self) -> float:
        return _logit(self.base_score)


def _logit(p: float) -> float:
    return float(np.log(p / (1.0 - p)))


def predict_forest_margin(X: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                          missing_left: torch.Tensor, value: torch.Tensor,
                          is_leaf: torch.Tensor, depth: int, base_margin: float) -> torch.Tensor:
    """Margins float32[B] of the forest for features X float32[B, F]
    (NaN = missing)."""
    B = X.shape[0]
    T, n_heap = feat.shape
    n_internal = 2 ** depth - 1
    # the reference's sentinel arithmetic: NaN → -1e30 (→ missing direction),
    # finite values clipped to ±1e18 so none can pass for missing
    x_clean = torch.where(torch.isnan(X), torch.full_like(X, -1e30), torch.clamp(X, -1e18, 1e18))
    f_int = feat[:, :n_internal]
    x_sel = x_clean[:, f_int.clamp(min=0).reshape(-1)].reshape(B, T, n_internal)
    go_left = torch.where(x_sel < -1e20, missing_left[None, :, :n_internal],
                          x_sel <= thr[None, :, :n_internal])              # (B, T, I)
    alive = ~(is_leaf[:, :n_internal] | (f_int < 0))                       # (T, I)
    node = torch.zeros((B, T), dtype=torch.int64, device=X.device)
    alive_b = alive[None].expand(B, T, n_internal)
    for _ in range(depth):
        gl = torch.gather(go_left, 2, node[..., None])[..., 0]
        al = torch.gather(alive_b, 2, node[..., None])[..., 0]
        node = torch.where(al, 2 * node + 2 - gl.to(torch.int64), node)
    margin = torch.gather(value[None].expand(B, T, n_heap), 2, node[..., None])[..., 0]
    base = torch.full((), base_margin, dtype=torch.float32, device=X.device)
    return base + margin.sum(dim=1)


# ------------------------------------------------------------------ training

def split_rows(x: torch.Tensor, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``x`` (n, ...) on one device cut into runs of the shards' lengths,
    each on its shard's device; rows past ``n`` (a mesh's padding) are 0."""
    out, lo = [], 0
    for sh in shards:
        part = x[lo : lo + sh.shape[0]]
        if part.shape[0] < sh.shape[0]:
            part = torch.cat([part, part.new_zeros((sh.shape[0] - part.shape[0],) + x.shape[1:])])
        out.append(part.to(sh.device))
        lo += sh.shape[0]
    return out


def boost_segment(
    bins: Sequence[torch.Tensor], y: torch.Tensor, w_hist: torch.Tensor,
    w_tr: torch.Tensor, w_ev: torch.Tensor, margins: torch.Tensor,
    *, depth: int, n_rounds: int, eta: float, beta: float, threshold: float,
    lambda_: float, min_child_weight: float,
):
    """``n_rounds`` boosting rounds with no host round trip between them.

    ``bins`` is a list of shards of the rows, each on its own device: one
    shard on one device, or a mesh's rows (padded at the end) split over its
    devices.  The per-row vectors (n,) lie on the first shard's device, where
    each round's gradients and margins are computed for all rows at once;
    the shards grow the histograms of their rows and route them
    (``build_tree_shards``).  Train and eval rows share the sample axis;
    {0, 1} masks pick each population: ``w_hist`` weights the histograms (0
    for eval rows), ``w_tr`` and ``w_ev`` the two custom-error sums.  Returns
    the stacked tree arrays (feat, split_bin, missing_left, value·eta,
    is_leaf), the per-round train and eval custom errors, and the final
    margins."""
    dev = margins.device
    n = margins.shape[0]
    n_heap = 2 ** (depth + 1) - 1
    trees = (
        torch.empty((n_rounds, n_heap), dtype=torch.int32, device=dev),
        torch.empty((n_rounds, n_heap), dtype=torch.int32, device=dev),
        torch.empty((n_rounds, n_heap), dtype=torch.bool, device=dev),
        torch.empty((n_rounds, n_heap), dtype=torch.float32, device=dev),
        torch.empty((n_rounds, n_heap), dtype=torch.bool, device=dev),
    )
    e_tr = torch.empty(n_rounds, dtype=torch.float32, device=dev)
    e_ev = torch.empty(n_rounds, dtype=torch.float32, device=dev)
    for r in range(n_rounds):
        g, h = margin_grad_hess(margins, y, beta)
        *tree, contrib = build_tree_shards(
            bins, split_rows(g * w_hist, bins), split_rows(h * w_hist, bins), depth=depth,
            lambda_=lambda_, min_child_weight=min_child_weight, n_rows=n)
        tree[3] = tree[3] * eta
        for dst, src in zip(trees, tree):
            dst[r] = src
        margins = margins + eta * torch.cat([c.to(dev) for c in contrib])[:n]
        pos = torch.sigmoid(margins) > threshold
        miss = y * (~pos)
        false_pos = (1.0 - y) * pos
        e_tr[r] = torch.sum(w_tr * miss) + torch.sum(w_tr * false_pos) * beta
        e_ev[r] = torch.sum(w_ev * miss) + torch.sum(w_ev * false_pos) * beta
    return trees, e_tr, e_ev, margins


def train_gbt(
    X: np.ndarray, y: np.ndarray,
    X_eval: np.ndarray, y_eval: np.ndarray,
    params: Optional[GBTParams] = None,
    verbose_every: int = 25,
    device="cuda",
    mesh=None,
) -> GBTModel:
    """Boosting with the custom objective, on ``device``.

    Rounds run in segments of ``min(50, num_boost_round)``.  Early stopping
    has XGBoost's semantics at segment granularity: training stops after
    the first segment whose best round is at least ``early_stopping_rounds``
    old, trees past the stop point are dropped, and ``best_ntree_limit`` is
    the best round + 1.

    ``mesh`` (``parallel.sharded.Mesh``; ``device`` is then its first
    device): data-parallel histograms.  The bins of the rows (train and
    eval) are padded with rows of weight 0 to a multiple of the mesh's size
    and split in order over its devices; each grows the histograms of its
    rows, they add up on the first device, and every shard routes its own
    rows.  The histograms add in fixed point with the shift of the unpadded
    rows, and the gradients are computed for all rows on the first device,
    as on one device (on the CPU an elementwise kernel rounds an array's
    vectorized body and its tail apart, so a shard's sigmoid could differ
    in the last bit): the trees are bit for bit those of one device."""
    p = params or GBTParams()
    devices = tuple(mesh.devices) if mesh is not None else (resolve_device(device),)
    dev = devices[0]
    N = X.shape[0]
    # |g| <= max(beta, 1) and |h| <= max(beta, 1) / 4 on 0/1 targets, so
    # every tree's shift is at least this one
    shift = int(fixed_point_shift(torch.tensor(max(p.beta, 1.0)), (N + len(X_eval)) * X.shape[1]))
    if shift < MIN_FIXED_POINT_SHIFT:
        raise ValueError(
            f"{N + len(X_eval)} rows x {X.shape[1]} features leave the fixed-point "
            f"histograms {shift} fractional bits (at least {MIN_FIXED_POINT_SHIFT} needed)")
    edges = compute_bin_edges(X)
    y_eval_np = y_eval.astype(np.float32)
    Ne = len(X_eval)
    # one sample axis: train rows, then eval rows (then a mesh's padding)
    bins_all = np.concatenate([bin_features(X, edges), bin_features(X_eval, edges)])
    per = -(-len(bins_all) // len(devices))
    bins_all = np.concatenate([bins_all, np.zeros((per * len(devices) - len(bins_all), X.shape[1]),
                                                  np.uint8)])
    bins_d = [torch.from_numpy(bins_all[i * per : (i + 1) * per]).to(d) for i, d in enumerate(devices)]
    y_all = np.concatenate([y.astype(np.float32), y_eval_np])
    w_hist = np.concatenate([np.ones(N, np.float32), np.zeros(Ne, np.float32)])

    y_d = torch.from_numpy(y_all).to(dev)
    w_hist_d = torch.from_numpy(w_hist).to(dev)
    w_ev_d = 1.0 - w_hist_d
    m = torch.full((len(y_all),), _logit(p.base_score), dtype=torch.float32, device=dev)

    segment = min(SEGMENT_ROUNDS, p.num_boost_round)
    chunks = []
    err_train_l: List[np.ndarray] = []
    err_eval_l: List[np.ndarray] = []
    best_round = 0
    best_err = np.inf
    rounds_done = 0
    while rounds_done < p.num_boost_round:
        n_rounds = min(segment, p.num_boost_round - rounds_done)
        trees, e_tr_d, e_ev_d, m = boost_segment(
            bins_d, y_d, w_hist_d, w_hist_d, w_ev_d, m,
            depth=p.depth, n_rounds=n_rounds, eta=p.eta, beta=p.beta,
            threshold=p.threshold, lambda_=p.lambda_,
            min_child_weight=p.min_child_weight,
        )
        chunks.append(tuple(t.cpu().numpy() for t in trees))
        e_tr, e_ev = e_tr_d.cpu().numpy(), e_ev_d.cpu().numpy()
        err_train_l.append(e_tr)
        err_eval_l.append(e_ev)
        for i, err in enumerate(e_ev):
            if err < best_err:
                best_err = float(err)
                best_round = rounds_done + i
        rounds_done += n_rounds
        if verbose_every:
            LOGGER.info("[%d] train-error:%.0f eval-error:%.0f (best %d: %.0f)",
                        rounds_done - 1, e_tr[-1], e_ev[-1], best_round, best_err)
        if rounds_done - 1 - best_round >= p.early_stopping_rounds:
            LOGGER.info("early stopping at round %d (best %d, eval-error %.0f)",
                        rounds_done - 1, best_round, best_err)
            break

    err_train = np.concatenate(err_train_l)
    err_eval = np.concatenate(err_eval_l)
    # truncate with XGBoost stop semantics
    stop = min(best_round + p.early_stopping_rounds, rounds_done - 1)
    T = stop + 1
    feat_a, split_a, ml_a, val_a, leaf_a = (
        np.concatenate([c[j] for c in chunks])[:T] for j in range(5)
    )

    m_host = m.cpu().numpy()
    pt = 1.0 / (1.0 + np.exp(-m_host[:N]))
    pe = 1.0 / (1.0 + np.exp(-m_host[N : N + Ne]))
    history = {
        "train_error": err_train[:T].tolist(),
        "eval_error": err_eval[:T].tolist(),
        "final_train_auc": auc_score(pt, y.astype(np.float32)),
        "final_eval_auc": auc_score(pe, y_eval_np),
    }
    if verbose_every:
        LOGGER.info(
            "final(%d rounds run) train-auc:%.6f eval-auc:%.6f | best round %d eval-error %.0f",
            rounds_done, history["final_train_auc"], history["final_eval_auc"],
            best_round, best_err,
        )

    # raw-value thresholds: thr = edges[f, k]
    thr_a = edges[np.maximum(feat_a, 0), np.clip(split_a, 0, N_EDGES - 1)].astype(np.float32)
    return GBTModel(
        feat=feat_a, threshold=thr_a, split_bin=split_a, missing_left=ml_a,
        value=val_a, is_leaf=leaf_a, edges=edges,
        base_score=p.base_score,
        best_ntree_limit=best_round + 1,
        depth=p.depth,
        history=history,
    )
