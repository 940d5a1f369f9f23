"""Kernel A: folded coarse scoring with the fused per-window pre-selection.

``score_window_select`` launches the CUDA kernel ``csrc/score_window.cu`` on
CUDA tensors and runs ``score_window_select_plain`` on CPU tensors; there is
no other route.  Both replace the TPU kernel
``doppelspeller_tpu/ops/jaccard_pallas.py::_score_kernel_v3``.

Titles are stored in natural order (bit t % 8 of byte t // 8), not in the
TPU kernel's per-tile permutation, but the window grouping is the
reference's: window s of a tile holds offsets o < W, offset o being
tile-local title 8·((o·S+s) mod nb) + (o·S+s) div nb (nb = tb/8,
S = tb/W).  Which per-window runner-ups are dropped, and so which titles
reach the rescore, depends on that grouping.

The top-k over the window maxima (``select_topk_windowed``) is exact with
ties to the lower window index.  The TPU reference used ``approx_max_k``;
off the TPU that call is an exact stable top-k, so the port is exact
everywhere.
"""

from __future__ import annotations

from typing import Tuple

import torch

from doppelspeller_tpu_torch import _build

# titles per chunk of the plain version (bounds its (U, chunk) unpacked bits)
_PLAIN_CHUNK = 1 << 16


def round_weights(w: torch.Tensor, score_dtype: str) -> torch.Tensor:
    """f32 weights as the contraction sees them: rounded to bf16 (and held
    in f32) when scoring in bf16, unchanged in f32."""
    if score_dtype == "bfloat16":
        return w.to(torch.bfloat16).to(torch.float32)
    if score_dtype == "float32":
        return w
    raise ValueError(f"unknown score_dtype {score_dtype!r}")


def window_titles(tb: int, W: int, device=None) -> torch.Tensor:
    """int64[W, S] tile-local title of offset o in window s."""
    nb = tb // 8
    S = tb // W
    c = (torch.arange(W, device=device)[:, None] * S
         + torch.arange(S, device=device)[None, :])
    return 8 * (c % nb) + c // nb


def score_window_select_plain(
    rows_u8: torch.Tensor, w: torch.Tensor, sums: torch.Tensor, maxint: torch.Tensor,
    nt: int, *, tb: int, W: int, folds: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel A (weights already rounded).

    rows_u8 u8 (U, ntp/8), w f32 (QB, U), sums f32 (ntp,), maxint f32 (QB,).
    Returns (wmax f32 (QB, ntp/W), warg_title i32 (QB, ntp/W))."""
    U, nbytes = rows_u8.shape
    ntp = nbytes * 8
    C = U // folds
    QB = w.shape[0]
    S = tb // W
    dev = rows_u8.device
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    local = window_titles(tb, W, dev)                       # (W, S)
    s_idx = torch.arange(S, device=dev)
    chunk = max((_PLAIN_CHUNK // tb) * tb, tb)
    wmax_parts, warg_parts = [], []
    for t0 in range(0, ntp, chunk):
        t1 = min(t0 + chunk, ntp)
        n = t1 - t0
        bits = ((rows_u8[:, t0 // 8 : t1 // 8, None] >> shifts) & 1)
        bits = bits.reshape(U, n).to(torch.float32)
        num = None
        for f in range(folds):
            part = w[:, f * C : (f + 1) * C] @ bits[f * C : (f + 1) * C]
            num = part if num is None else torch.minimum(num, part)
        denom = (sums[None, t0:t1] + maxint[:, None]) - num
        jacc = num / torch.clamp(denom, min=1e-9)
        tpos = torch.arange(t0, t1, device=dev)
        jacc = torch.where(tpos[None, :] < nt, jacc, torch.full_like(jacc, -1.0))
        n_tiles = n // tb
        # (QB, tiles, W, S): score of offset o in window s of each tile
        jw = jacc.reshape(QB, n_tiles, tb)[:, :, local]
        m = jw.max(dim=2).values                             # (QB, tiles, S)
        off = (jw >= m[:, :, None, :]).to(torch.int32).argmax(dim=2)   # first max
        tile0 = t0 + tb * torch.arange(n_tiles, device=dev)
        title = tile0[None, :, None] + local.reshape(-1)[off.to(torch.int64) * S + s_idx]
        wmax_parts.append(m.reshape(QB, n_tiles * S))
        warg_parts.append(title.reshape(QB, n_tiles * S).to(torch.int32))
    return torch.cat(wmax_parts, dim=1), torch.cat(warg_parts, dim=1)


def score_window_select(
    rows_u8: torch.Tensor, w: torch.Tensor, sums: torch.Tensor, maxint: torch.Tensor,
    nt: int, *, tb: int, W: int, folds: int, score_dtype: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse folded scores reduced per window.

    rows_u8 u8 (folds·C, ntp/8) stacked folded occupancy bits, w f32 (QB,
    folds·C) folded weights, sums f32 (ntp,), maxint f32 (QB,), nt real
    titles.  Returns (wmax f32 (QB, ntp/W), warg_title i32 (QB, ntp/W)):
    window g = tile·S + s holds its max score and the global title of the
    first offset reaching it.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    U, nbytes = rows_u8.shape
    ntp = nbytes * 8
    QB = w.shape[0]
    if rows_u8.dtype != torch.uint8 or w.dtype != torch.float32:
        raise TypeError("rows_u8 must be uint8 and w float32")
    if w.shape[1] != U or U % folds or sums.shape != (ntp,) or maxint.shape != (QB,):
        raise ValueError(f"shape mismatch: rows {tuple(rows_u8.shape)}, w {tuple(w.shape)}, "
                         f"sums {tuple(sums.shape)}, maxint {tuple(maxint.shape)}")
    if ntp % tb or tb % W:
        raise ValueError(f"title count {ntp} / tile {tb} / window {W} do not divide")
    wr = round_weights(w, score_dtype)
    dev = rows_u8.device
    if dev.type == "cpu":
        return score_window_select_plain(rows_u8, wr, sums, maxint, nt, tb=tb, W=W, folds=folds)
    if dev.type != "cuda":
        raise RuntimeError(f"kernel A runs on CUDA tensors, not {dev}")
    if tb != 128 * W or W not in (1, 2, 4, 8, 16):
        raise ValueError(f"kernel A takes tb = 128·W with W in 1..16, got tb={tb} W={W}")
    tensors = (rows_u8, wr, sums, maxint)
    if any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError("kernel A inputs must be contiguous and on one device")
    if sums.dtype != torch.float32 or maxint.dtype != torch.float32:
        raise TypeError("sums and maxint must be float32")
    if rows_u8.data_ptr() % 16:
        raise ValueError("rows_u8 must be 16-byte aligned")
    wmax = torch.empty((QB, ntp // W), dtype=torch.float32, device=dev)
    warg = torch.empty((QB, ntp // W), dtype=torch.int32, device=dev)
    if QB == 0:
        return wmax, warg
    rc = _build.lib().doppel_score_window_select(
        rows_u8.data_ptr(), wr.data_ptr(), sums.data_ptr(), maxint.data_ptr(),
        wmax.data_ptr(), warg.data_ptr(), QB, U // folds, folds, nbytes, tb, W,
        ntp // tb, int(nt), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "doppel_score_window_select")
    score_window_select.launches += 1
    return wmax, warg


score_window_select.launches = 0


def select_topk_windowed(wmax: torch.Tensor, warg_title: torch.Tensor, k: int):
    """Exact top-k over the window maxima, ties to the lower window index
    (the order ``lax.top_k`` gives).  Returns (vals f32 (QB, k),
    titles i32 (QB, k))."""
    vals, order = torch.sort(wmax, dim=1, descending=True, stable=True)
    order = order[:, :k]
    return vals[:, :k], torch.gather(warg_title, 1, order)
