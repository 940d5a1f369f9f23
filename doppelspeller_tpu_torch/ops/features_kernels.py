"""Kernel B: best sliding-window LCS ratio per candidate word.

``window_best`` launches the CUDA kernel ``csrc/window_lcs.cu`` on CUDA
tensors and runs ``window_best_plain`` on CPU tensors; there is no other
route.  Both replace the TPU kernel
``doppelspeller_tpu/ops/features_pallas.py::_kernel`` (``window_best_pallas``)
with exactly its semantics: for each (pair, word slot) and window start
p < TL the bit-parallel LCS of the word (≤ 32 chars) against the spaceless
query characters [p, p + wlen) (none past ``q_wo_len``; pad codes never
match), ratio floor(200·lcs / max(wlen + min(wlen, qwol − p), 1)), −1 for
an invalid window, and the first p reaching the best ratio.
"""

from __future__ import annotations

from typing import Tuple

import torch

from doppelspeller_tpu_torch import _build
from doppelspeller_tpu_torch.ops.levenshtein import popcount32

WL_MAX = 32


def window_best_plain(word_chars: torch.Tensor, word_len: torch.Tensor,
                      q_wo: torch.Tensor, q_wo_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B, vectorized over (word, p) for the
    word slots that hold a word; an empty slot has no valid window (ratio
    −1 at p = 0)."""
    B, W, WL = word_chars.shape
    TL = q_wo.shape[1]
    dev = q_wo.device
    best = torch.full((B * W,), -1.0, dtype=torch.float32, device=dev)
    best_p = torch.zeros(B * W, dtype=torch.int32, device=dev)
    live = torch.nonzero(word_len.reshape(-1) > 0).flatten()
    if live.numel() == 0:
        return best.reshape(B, W), best_p.reshape(B, W)
    pair = live // W
    wlen = torch.clamp(word_len.reshape(-1)[live].to(torch.int64), max=WL_MAX)[:, None]  # (N, 1)
    chars = word_chars.reshape(B * W, WL)[live].to(torch.int64)                         # (N, WL)
    qwol = q_wo_len.to(torch.int64)[pair][:, None]                                      # (N, 1)
    text = q_wo.to(torch.int64)[pair]                                                    # (N, TL)
    a = torch.arange(TL, device=dev)[None, :]
    text_ok = (a < qwol) & (text > 0)
    # M[n, a]: bit i set where word char i equals text char a; padded by WL
    # zero columns so window p reads columns p .. p + WL - 1
    M = torch.zeros((len(live), TL + WL), dtype=torch.int64, device=dev)
    for i in range(WL):
        M[:, :TL] |= ((chars[:, i, None] == text) & text_ok).to(torch.int64) << i
    mask = torch.where(wlen >= 32, torch.full_like(wlen, 0xFFFFFFFF), (torch.ones_like(wlen) << wlen) - 1)
    V = mask.expand(-1, TL).clone()
    for r in range(WL):
        U = V & torch.where(r < wlen, M[:, r : r + TL], torch.zeros_like(V))
        V = ((V + U) | (V - U)) & mask
    lcs = wlen - popcount32(V)                                                           # (N, TL)
    total = (wlen + torch.minimum(wlen, qwol - a)).to(torch.float32)
    ratio = torch.floor(200.0 * lcs.to(torch.float32) / torch.clamp(total, min=1.0))
    ratio = torch.where(a < qwol, ratio, torch.full_like(ratio, -1.0))
    m = ratio.max(dim=1).values
    best[live] = m
    best_p[live] = (ratio == m[:, None]).to(torch.int32).argmax(dim=1).to(torch.int32)   # first max
    return best.reshape(B, W), best_p.reshape(B, W)


def window_best(word_chars: torch.Tensor, word_len: torch.Tensor,
                q_wo: torch.Tensor, q_wo_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """word_chars u8 (B, W, WL ≤ 32), word_len i32 (B, W), q_wo u8 (B, TL),
    q_wo_len i32 (B,) → (best_ratio f32 (B, W), best_p i32 (B, W)).  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    B, W, WL = word_chars.shape
    TL = q_wo.shape[1]
    if WL > WL_MAX:
        raise ValueError(f"kernel B takes words of at most {WL_MAX} chars, got WL={WL}")
    if word_len.shape != (B, W) or q_wo.shape[0] != B or q_wo_len.shape != (B,):
        raise ValueError("window_best: shape mismatch")
    dev = q_wo.device
    if dev.type == "cpu":
        return window_best_plain(word_chars, word_len, q_wo, q_wo_len)
    if dev.type != "cuda":
        raise RuntimeError(f"kernel B runs on CUDA tensors, not {dev}")
    tensors = (word_chars, word_len, q_wo, q_wo_len)
    if any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError("kernel B inputs must be contiguous and on one device")
    if (word_chars.dtype != torch.uint8 or q_wo.dtype != torch.uint8
            or word_len.dtype != torch.int32 or q_wo_len.dtype != torch.int32):
        raise TypeError("kernel B takes uint8 chars and int32 lengths")
    ratio = torch.empty((B, W), dtype=torch.float32, device=dev)
    pos = torch.empty((B, W), dtype=torch.int32, device=dev)
    if B * W == 0:
        return ratio, pos
    with torch.cuda.device(dev):          # the launch goes to the tensors' card
        rc = _build.lib().doppel_window_best(
            word_chars.data_ptr(), word_len.data_ptr(), q_wo.data_ptr(), q_wo_len.data_ptr(),
            ratio.data_ptr(), pos.data_ptr(), B, W, WL, TL,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "doppel_window_best")
    _build.count(window_best)
    return ratio, pos


window_best.launches = 0
