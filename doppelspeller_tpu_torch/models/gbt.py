"""Gradient-boosted tree inference.

Reads the JAX package's ``model.npz`` (``GBTModel.save``) and evaluates the
forest with the same semantics as its ``predict_forest_margin``: at an
internal node a NaN feature goes the node's missing direction, otherwise
left when ``x <= threshold``; a node is a leaf when ``is_leaf`` or
``feat < 0``.  The TPU version selects features with a one-hot matmul; here
it is a gather and the walk is ``depth`` gathers over (batch, tree).
Training is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


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

    @property
    def num_trees(self) -> int:
        return self.feat.shape[0]

    @classmethod
    def from_arrays(cls, arrays: Dict[str, object]) -> "GBTModel":
        """Build from a mapping of the model's fields (numpy arrays and
        scalars), e.g. a loaded ``model.npz`` or a JAX ``GBTModel``'s
        ``__dict__``."""
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
        )

    @classmethod
    def load(cls, path: str) -> "GBTModel":
        with np.load(path) as z:
            return cls.from_arrays({k: z[k] for k in z.files})

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
        return float(np.log(self.base_score / (1 - self.base_score)))


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
    base = torch.tensor(base_margin, dtype=torch.float32, device=X.device)
    return base + margin.sum(dim=1)
