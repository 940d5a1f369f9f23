"""Batched LCS / Levenshtein-ratio (indel distance) on the device.

The JAX package's ``ops/levenshtein.py::lcs_kernel``: the Crochemore-
Iliopoulos-Pinzón bit-parallel LCS with the DP column over ``a`` packed into
⌈La/32⌉ 32-bit words and explicit carry and borrow chains across words.
``lcs`` takes one of two routes, by the tensors' device: CUDA tensors
launch kernel F (``csrc/lcs_pairs.cu``, one pair a thread), CPU tensors run
``lcs_plain``; there is no other route, and the two give the same integers.
``lcs_plain`` is the plain PyTorch version: PyTorch has no uint32 add or
popcount, so every 32-bit word is held in an int64 lane: sums and
differences are taken in 64 bits, the carry and borrow are read from bit 32
and the sign, and the result is masked back to 32 bits; the popcount is a
SWAR reduction.  ratio(a, b) = 200·LCS / (|a| + |b|).  ``batched_ratio``
and ``ratio_rounded`` are the JAX module's host wrappers over numpy pairs,
grouped by length bucket.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from doppelspeller_tpu_torch import _build
from doppelspeller_tpu_torch.config import Config, get_config

_MASK32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit value held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def lcs_plain(a: torch.Tensor, la: torch.Tensor, b: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """LCS length per pair, in plain PyTorch (``lcs``'s CPU route).

    a: uint8 (B, La) zero-padded, la: int (B,); likewise b/lb.  Pad codes (0)
    never match; positions past the lengths are ignored, and a length past
    the width reads as the width.  Returns int32 (B,)."""
    B, La = a.shape
    Lb = b.shape[1]
    dev = a.device
    n_words = (La + 31) // 32
    la = la.to(torch.int64)
    lb = lb.to(torch.int64)
    pos = torch.arange(La, device=dev)
    a_valid = (pos[None, :] < la[:, None]) & (a > 0)
    b_valid = (torch.arange(Lb, device=dev)[None, :] < lb[:, None]) & (b > 0)
    # match masks M[b, j, w]: bit i of word w set where a[b, 32w+i] == b[b, j]
    M = torch.zeros((B, Lb, n_words), dtype=torch.int64, device=dev)
    bl = b.to(torch.int64)
    for i in range(La):
        eq = (a[:, i, None].to(torch.int64) == bl) & a_valid[:, i, None] & b_valid
        M[:, :, i // 32] |= eq.to(torch.int64) << (i % 32)
    wpos = torch.arange(n_words * 32, device=dev).reshape(n_words, 32)
    pow2 = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(32, device=dev)
    mask_a = ((wpos[None] < la[:, None, None]).to(torch.int64) * pow2).sum(dim=2)  # (B, W)
    V = [mask_a[:, w] for w in range(n_words)]
    for j in range(Lb):
        U = [V[w] & M[:, j, w] for w in range(n_words)]
        carry = torch.zeros_like(V[0])
        borrow = torch.zeros_like(V[0])
        new = []
        for w in range(n_words):
            s = V[w] + U[w] + carry
            carry = s >> 32
            d = V[w] - U[w] - borrow
            borrow = (d < 0).to(torch.int64)
            new.append(((s | d) & _MASK32) & mask_a[:, w])
        V = new
    ones = sum(popcount32(v) for v in V)
    # V starts as the mask over min(la, 32·n_words) bits and loses one per match
    return (torch.clamp(la, max=n_words * 32) - ones).to(torch.int32)


# kernel F takes rows of at most this many characters
WIDTH_MAX = 256


def lcs(a: torch.Tensor, la: torch.Tensor, b: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """LCS length per pair: ``lcs_plain``'s integers.  CPU tensors take
    ``lcs_plain``; CUDA tensors launch kernel F on the current stream.

    On the card ``a`` and ``b`` are uint8 (B, ≤ 256) with contiguous rows
    (a row stride of their own is taken: a column slice of a wider tensor),
    ``la`` and ``lb`` contiguous int32 or int64 (B,), all on one card; any
    other input raises.  Every uint8 value is a code, as in ``lcs_plain``:
    codes past the 38-letter alphabet match their equals."""
    B, La = a.shape
    Lb = b.shape[1]
    dev = a.device
    if dev.type == "cpu":
        return lcs_plain(a, la, b, lb)
    if dev.type != "cuda":
        raise RuntimeError(f"kernel F runs on CUDA tensors, not {dev}")
    if b.shape[0] != B or la.shape != (B,) or lb.shape != (B,):
        raise ValueError("lcs: shape mismatch")
    if La > WIDTH_MAX or Lb > WIDTH_MAX:
        raise ValueError(f"kernel F takes rows of at most {WIDTH_MAX} chars, got {La} and {Lb}")
    if any(t.device != dev for t in (la, b, lb)):
        raise ValueError("kernel F inputs must be on one device")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8 or any(
            t.dtype not in (torch.int32, torch.int64) for t in (la, lb)):
        raise TypeError("kernel F takes uint8 characters and int32 or int64 lengths")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    if (any(t.shape[1] > 1 and t.stride(1) != 1 for t in (a, b))
            or not (la.is_contiguous() and lb.is_contiguous())):
        raise ValueError("kernel F takes rows of contiguous characters and contiguous lengths")
    with torch.cuda.device(dev):          # the launch goes to the tensors' card
        rc = _build.lib().doppel_lcs_pairs(
            a.data_ptr(), a.stride(0), la.data_ptr(), la.dtype == torch.int64,
            b.data_ptr(), b.stride(0), lb.data_ptr(), lb.dtype == torch.int64,
            out.data_ptr(), B, La, Lb, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "doppel_lcs_pairs")
    _build.count(lcs)
    return out


lcs.launches = 0


def floor_ratio(lcs_len: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """floor(200·lcs / total) as float32, 100 where total is 0."""
    total_f = total.to(torch.float32)
    r = 200.0 * lcs_len.to(torch.float32) / torch.clamp(total_f, min=1.0)
    return torch.floor(torch.where(total_f > 0, r, torch.full_like(r, 100.0)))


def rounded_ratio(a, la, b, lb) -> torch.Tensor:
    """round-half-even(200·lcs / max(la + lb, 1)) as int32 (the python
    ``round`` of the Levenshtein ratio)."""
    total = torch.clamp(la.to(torch.int64) + lb.to(torch.int64), min=1).to(torch.float32)
    r = 200.0 * lcs(a, la, b, lb).to(torch.float32) / total
    return torch.round(r).to(torch.int32)


def batched_ratio(enc_a: np.ndarray, len_a: np.ndarray, enc_b: np.ndarray, len_b: np.ndarray,
                  config: Optional[Config] = None, device="cuda") -> np.ndarray:
    """Host wrapper: unrounded float32 ratios 200·lcs / (|a| + |b|) (100
    where both are empty) for N pairs of u8 encodings (N, width), any
    lengths ≤ 256, computed on ``device``.  Pairs are grouped by
    ``config.length_buckets`` (the max of the two lengths; the widest
    bucket is the encodings' width) and cut into chunks that bound the
    (B, Lb, La) match masks, as the JAX package's ``batched_ratio`` does.
    Callers apply the reference's integer semantics (``ratio_rounded``, or
    a floor)."""
    cfg = config or get_config()
    len_a = np.asarray(len_a, dtype=np.int32)
    len_b = np.asarray(len_b, dtype=np.int32)
    out = np.zeros(len(len_a), dtype=np.float32)
    buckets = [b for b in cfg.length_buckets if b < enc_a.shape[1]] + [enc_a.shape[1]]
    bucket_idx = np.searchsorted(np.asarray(buckets), np.maximum(len_a, len_b))
    for bi, bkt in enumerate(buckets):
        sel = np.flatnonzero(bucket_idx == bi)
        chunk = int(np.clip((1 << 25) // (bkt * bkt), 64, cfg.pair_block))
        for start in range(0, len(sel), chunk):
            idx = sel[start : start + chunk]
            la = torch.from_numpy(np.minimum(len_a[idx], bkt)).to(device)
            lb = torch.from_numpy(np.minimum(len_b[idx], bkt)).to(device)
            lcs_len = lcs(torch.from_numpy(enc_a[idx, :bkt]).to(device), la,
                          torch.from_numpy(enc_b[idx, :bkt]).to(device), lb)
            total = (la + lb).to(torch.float32)
            r = torch.where(total > 0, 200.0 * lcs_len.to(torch.float32) / total,
                            torch.full_like(total, 100.0))
            out[idx] = r.cpu().numpy()
    return out


def ratio_rounded(enc_a: np.ndarray, len_a: np.ndarray, enc_b: np.ndarray, len_b: np.ndarray,
                  config: Optional[Config] = None, device="cuda") -> np.ndarray:
    """``batched_ratio`` rounded half to even, as int32 (python-Levenshtein's
    ``int(round(x))``)."""
    return np.round(batched_ratio(enc_a, len_a, enc_b, len_b, config, device)).astype(np.int32)
