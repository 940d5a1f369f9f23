"""Batched LCS / Levenshtein-ratio (indel distance) in plain PyTorch.

The JAX package's ``ops/levenshtein.py::lcs_kernel``: the Crochemore-
Iliopoulos-Pinzón bit-parallel LCS with the DP column over ``a`` packed into
⌈La/32⌉ 32-bit words and explicit carry and borrow chains across words.
PyTorch has no uint32 add or popcount, so every 32-bit word is held in an
int64 lane: sums and differences are taken in 64 bits, the carry and borrow
are read from bit 32 and the sign, and the result is masked back to 32 bits;
the popcount is a SWAR reduction.  ratio(a, b) = 200·LCS / (|a| + |b|).
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit value held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def lcs(a: torch.Tensor, la: torch.Tensor, b: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """LCS length per pair.

    a: uint8 (B, La) zero-padded, la: int (B,); likewise b/lb.  Pad codes (0)
    never match; positions past the lengths are ignored.  Returns int32 (B,)."""
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
