"""Retrieval kernels: A (window select), C (row gather), D (full matrix) and
E (sparse weights, exact top-k).

Each wrapper launches its CUDA kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors; there is no other route.  A launch runs
with its tensors' card made the current device, since the kernels' launch
set-up (``cudaFuncSetAttribute``) acts on the current device: a shard of a
mesh on another card than the current one launches there.  They replace the
TPU kernels of ``doppelspeller_tpu/ops/jaccard_pallas.py``:

- A ``score_window_select`` (``csrc/score_window.cu``) ↔ ``_score_kernel_v3``:
  scores fused with the per-window pre-selection; ``folds=2`` on the
  folded path; ``folds=1`` on the exact path, where it reads the union's
  rows straight from the packed index (``union_ids``).
- C ``gather_rows`` (``csrc/gather_rows.cu``) ↔ ``_gather_rows_kernel``: the
  entry and its kernel; no path of ``Matcher.predict`` launches it, since A
  and D gather in their own loads.
- D ``score_full`` (``csrc/score_full.cu``) ↔ ``_score_kernel_v2`` with
  the union's row gather before it: the full (QB, ntp) Jaccard matrix, bf16
  out when scoring in bf16, else f32, reading the union's rows straight
  from the packed index; on A's tensor-core mainloop and weight image.
- E ``jaccard_topk_v1`` (``csrc/score_sparse_topk.cu``) ↔ ``_score_kernel``
  (``jaccard_topk_pallas``) with its densified weights and exact top-k:
  only the weighted slots scored, on the CUDA cores, each title range's
  top-k selected on chip and the ranges merged by a second kernel.

Titles are stored in natural order (bit t % 8 of byte t // 8), not in the
TPU kernels' per-tile permutation π, but every choice that depends on π is
the reference's.  Kernel A groups windows as the reference does: window s
of a tile holds offsets o < W, offset o being tile-local title
8·((o·S+s) mod nb) + (o·S+s) div nb (nb = tb/8, S = tb/W), and which
runner-ups each window drops decides which titles reach the next stage.
Kernel D writes its columns in π order (column c of a tile holds title
8·(c mod nb) + c div nb), and its top-k breaks ties toward the lower
column, as the reference's does; kernel E's keys carry the same order.

The top-k selects are exact.  The TPU reference used ``approx_max_k``; off
the TPU that call is an exact top-k, so the port is exact everywhere.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from doppelspeller_tpu_torch import _build
from doppelspeller_tpu_torch.ops import features_kernels as fk
from doppelspeller_tpu_torch.ops import levenshtein as lev

# titles per chunk of the plain versions (bounds their (U, chunk) unpacked bits)
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


def unpermute_positions(cols: torch.Tensor, tb: int) -> torch.Tensor:
    """Title of each π column (the inverse of D's column order)."""
    nb = tb // 8
    c = cols % tb
    return cols - c + 8 * (c % nb) + c // nb


def _jaccard_chunks(rows_u8: torch.Tensor, w: torch.Tensor, sums: torch.Tensor,
                    maxint: torch.Tensor, nt: int, tb: int,
                    folds: int) -> Iterator[Tuple[int, torch.Tensor]]:
    """(t0, jacc f32 (QB, n)) over chunks of whole tiles, natural title
    order: the plain versions' bit unpack, f32 matmuls (min over folds) and
    Jaccard normalisation."""
    U, nbytes = rows_u8.shape
    ntp = nbytes * 8
    C = U // folds
    dev = rows_u8.device
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    chunk = max((_PLAIN_CHUNK // tb) * tb, tb)
    for t0 in range(0, ntp, chunk):
        t1 = min(t0 + chunk, ntp)
        bits = ((rows_u8[:, t0 // 8 : t1 // 8, None] >> shifts) & 1)
        bits = bits.reshape(U, t1 - t0).to(torch.float32)
        num = None
        for f in range(folds):
            part = w[:, f * C : (f + 1) * C] @ bits[f * C : (f + 1) * C]
            num = part if num is None else torch.minimum(num, part)
        denom = (sums[None, t0:t1] + maxint[:, None]) - num
        jacc = num / torch.clamp(denom, min=1e-9)
        tpos = torch.arange(t0, t1, device=dev)
        yield t0, torch.where(tpos[None, :] < nt, jacc, torch.full_like(jacc, -1.0))


def _check_score_inputs(U: int, nbytes: int, rows_u8, w, sums, maxint, folds: int) -> None:
    """Kernel A's inputs: U rows scored, of ``nbytes`` bytes each."""
    if rows_u8.dtype != torch.uint8 or w.dtype != torch.float32:
        raise TypeError("rows_u8 must be uint8 and w float32")
    if w.shape[1] != U or U % folds or sums.shape != (nbytes * 8,) or maxint.shape != (w.shape[0],):
        raise ValueError(f"shape mismatch: rows {tuple(rows_u8.shape)}, w {tuple(w.shape)}, "
                         f"sums {tuple(sums.shape)}, maxint {tuple(maxint.shape)}")


def check_launch(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name} runs on CUDA tensors, not {dev}")
    if any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} inputs must be contiguous and on one device")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} inputs must be 16-byte aligned")
    return dev


# ---------------------------------------------------------------- kernel A

def score_window_select_plain(
    rows_u8: torch.Tensor, w: torch.Tensor, sums: torch.Tensor, maxint: torch.Tensor,
    nt: int, *, tb: int, W: int, folds: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel A (weights already rounded).

    rows_u8 u8 (U, ntp/8), w f32 (QB, U), sums f32 (ntp,), maxint f32 (QB,).
    Returns (wmax f32 (QB, ntp/W), warg_title i32 (QB, ntp/W))."""
    QB = w.shape[0]
    S = tb // W
    dev = rows_u8.device
    local = window_titles(tb, W, dev)                       # (W, S)
    s_idx = torch.arange(S, device=dev)
    wmax_parts, warg_parts = [], []
    for t0, jacc in _jaccard_chunks(rows_u8, w, sums, maxint, nt, tb, folds):
        n_tiles = jacc.shape[1] // tb
        # (QB, tiles, W, S): score of offset o in window s of each tile
        jw = jacc.reshape(QB, n_tiles, tb)[:, :, local]
        m = jw.max(dim=2).values                             # (QB, tiles, S)
        off = (jw >= m[:, :, None, :]).to(torch.int32).argmax(dim=2)   # first max
        tile0 = t0 + tb * torch.arange(n_tiles, device=dev)
        title = tile0[None, :, None] + local.reshape(-1)[off.to(torch.int64) * S + s_idx]
        wmax_parts.append(m.reshape(QB, n_tiles * S))
        warg_parts.append(title.reshape(QB, n_tiles * S).to(torch.int32))
    return torch.cat(wmax_parts, dim=1), torch.cat(warg_parts, dim=1)


def untied_windows(rows_u8: torch.Tensor, w: torch.Tensor, sums: torch.Tensor,
                   maxint: torch.Tensor, nt: int, *, tb: int, W: int, folds: int,
                   rtol: float) -> torch.Tensor:
    """bool (QB, ntp/W): windows whose best score exceeds their second best
    by more than ``rtol`` of it (weights already rounded), so that no
    summation order can change which offset wins.  Two window selects are
    held to equal titles there."""
    QB = w.shape[0]
    local = window_titles(tb, W, rows_u8.device)
    parts = []
    for _, jacc in _jaccard_chunks(rows_u8, w, sums, maxint, nt, tb, folds):
        top2 = jacc.reshape(QB, -1, tb)[:, :, local].topk(2, dim=2).values    # (QB, tiles, 2, S)
        parts.append((top2[:, :, 0] - top2[:, :, 1] > rtol * top2[:, :, 0].abs()).reshape(QB, -1))
    return torch.cat(parts, dim=1)


# kernel A's tiles: queries per block (wgmma N), rows per pipeline stage
_A_QUERIES, _A_ROWS = 128, 64


def kernel_a_queries(qb: int) -> int:
    """The query rows kernel A computes for a block of ``qb`` queries: its
    weight image pads them with zero weights to whole 128-query tiles."""
    return -(-qb // _A_QUERIES) * _A_QUERIES


def split_weights(w: torch.Tensor, score_dtype: str) -> torch.Tensor:
    """bf16 parts (P, QB, U) of f32 weights (QB, U) whose sum is the weight
    the contraction sees: one part, the bf16-rounded weight, in bf16 mode;
    three, hi + mid + lo, in f32 mode.  Each part takes the next 8
    significant bits of what the earlier ones left, so the three sum exactly
    to every f32 weight of the IDF range, and with 0/1 bits every product
    on the tensor cores is exact."""
    if score_dtype == "bfloat16":
        return w.to(torch.bfloat16)[None]
    if score_dtype != "float32":
        raise ValueError(f"unknown score_dtype {score_dtype!r}")
    hi = w.to(torch.bfloat16)
    rest = w - hi.to(torch.float32)
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def kernel_a_weights(w: torch.Tensor, folds: int, score_dtype: str) -> torch.Tensor:
    """Kernel A's weight image (kernel D's with folds=1): bf16 (P, folds, QB/128, C/64, 8, 16, 8, 8),
    QB and the C rows of a fold padded with zero weights to whole blocks.
    Entry [p, f, b, c, kh, nh, nl, kl] is part p of the weight of query
    128·b + 8·nh + nl on row f·C + 64·c + 8·kh + kl, so each (part, fold,
    query block, row chunk) is one contiguous 16 KB wgmma B tile in
    core-matrix order (8 queries × 8 rows per 128 bytes)."""
    parts = split_weights(w, score_dtype)
    P, QB, U = parts.shape
    C = U // folds
    nq = kernel_a_queries(QB)
    nch = -(-C // _A_ROWS)
    img = torch.zeros((P, nq, folds, nch * _A_ROWS), dtype=torch.bfloat16, device=w.device)
    img[:, :QB, :, :C] = parts.view(P, QB, folds, C)
    img = img.view(P, nq // _A_QUERIES, 16, 8, folds, nch, 8, 8).permute(0, 4, 1, 5, 6, 2, 3, 7)
    return img.contiguous()


def score_window_select(
    rows_u8: torch.Tensor, w: torch.Tensor, sums: torch.Tensor, maxint: torch.Tensor,
    nt: int, *, tb: int, W: int, folds: int, score_dtype: str,
    union_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores reduced per window.

    rows_u8 u8 (folds·C, ntp/8): stacked folded occupancy bits (folded
    path) or a union's rows with folds=1; w f32 (QB, folds·C) weights, sums
    f32 (ntp,), maxint f32 (QB,), nt real titles.  With ``union_ids`` (U,)
    (exact path; folds=1 only, repeats and the padding id 0 allowed)
    rows_u8 is the packed index u8 (V, ntp/8) and the rows scored are
    ``rows_u8[union_ids]``, w f32 (QB, U).  The ids must lie in [0, V): the
    kernel reads ``rows_u8[id]`` unchecked, as ``gather_rows`` does, and
    ``ExactEngine.topk_block`` holds its plans to that on the host.
    Returns (wmax f32 (QB, ntp/W), warg_title i32 (QB, ntp/W)): window
    g = tile·S + s holds its max score and the global title of the first
    offset reaching it.  CPU tensors take the plain versions (gather, then
    score); CUDA tensors launch the kernel, which takes tb = 2048, W = 16
    (the only tiling any path uses) and folds of 1 or 2, and with
    ``union_ids`` reads the union's rows straight from the packed index."""
    if union_ids is not None:
        if folds != 1:
            raise ValueError(f"union_ids go with folds=1, got folds={folds}")
        if union_ids.dim() != 1:
            raise TypeError("union_ids must be 1-D")
    if rows_u8.dim() != 2:
        raise TypeError("rows_u8 must be a 2-D uint8 matrix")
    nbytes = rows_u8.shape[1]
    U = rows_u8.shape[0] if union_ids is None else union_ids.shape[0]
    ntp = nbytes * 8
    QB = w.shape[0]
    _check_score_inputs(U, nbytes, rows_u8, w, sums, maxint, folds)
    if ntp % tb or tb % W:
        raise ValueError(f"title count {ntp} / tile {tb} / window {W} do not divide")
    if rows_u8.device.type == "cpu":
        rows = rows_u8 if union_ids is None else gather_rows_plain(rows_u8, union_ids)
        return score_window_select_plain(rows, round_weights(w, score_dtype), sums, maxint, nt,
                                         tb=tb, W=W, folds=folds)
    if tb != 2048 or W != 16 or folds not in (1, 2) or U == 0:
        raise ValueError(f"kernel A takes tb=2048, W=16, folds 1 or 2 and at least one row, got "
                         f"tb={tb} W={W} folds={folds} U={U}")
    if sums.dtype != torch.float32 or maxint.dtype != torch.float32:
        raise TypeError("sums and maxint must be float32")
    dev = rows_u8.device
    wmax = torch.empty((QB, ntp // W), dtype=torch.float32, device=dev)
    warg = torch.empty((QB, ntp // W), dtype=torch.int32, device=dev)
    if QB == 0:
        return wmax, warg
    img = kernel_a_weights(w, folds, score_dtype)
    ids32 = None if union_ids is None else union_ids.to(torch.int32).contiguous()
    check_launch("kernel A", rows_u8, img, sums, maxint, *(() if ids32 is None else (ids32,)))
    with torch.cuda.device(dev):
        rc = _build.lib().doppel_score_window_select(
            rows_u8.data_ptr(), None if ids32 is None else ids32.data_ptr(), img.data_ptr(),
            sums.data_ptr(), maxint.data_ptr(), wmax.data_ptr(), warg.data_ptr(), QB, U // folds,
            folds, nbytes, img.shape[0], ntp // tb, int(nt),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "doppel_score_window_select")
    _build.count(score_window_select)
    if ids32 is not None:
        _build.count(score_window_select, "gathered")
    return wmax, warg


# launches of kernel A, and those among them that gathered (union_ids given)
score_window_select.launches = 0
score_window_select.gathered = 0


def select_topk_windowed(wmax: torch.Tensor, warg_title: torch.Tensor, k: int):
    """Exact top-k over the window maxima, ties to the lower window index
    (the order ``lax.top_k`` gives).  Returns (vals f32 (QB, k),
    titles i32 (QB, k))."""
    vals, order = torch.sort(wmax, dim=1, descending=True, stable=True)
    order = order[:, :k]
    return vals[:, :k], torch.gather(warg_title, 1, order)


# ---------------------------------------------------------------- kernel C

def gather_rows_plain(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C."""
    return torch.index_select(src, 0, ids.to(torch.int64))


def gather_rows(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """src u8 (V, nbytes), ids (U,) row ids in [0, V) → u8 (U, nbytes).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if src.dtype != torch.uint8 or src.dim() != 2 or ids.dim() != 1:
        raise TypeError("gather_rows takes a 2-D uint8 matrix and 1-D ids")
    if src.device.type == "cpu":
        return gather_rows_plain(src, ids)
    ids32 = ids.to(torch.int32).contiguous()
    dev = check_launch("kernel C", src, ids32)
    U, nbytes = ids32.shape[0], src.shape[1]
    if nbytes % 16:
        raise ValueError(f"kernel C takes rows of a multiple of 16 bytes, got {nbytes}")
    out = torch.empty((U, nbytes), dtype=torch.uint8, device=dev)
    if U == 0:
        return out
    with torch.cuda.device(dev):
        rc = _build.lib().doppel_gather_rows(src.data_ptr(), ids32.data_ptr(), out.data_ptr(), U,
                                             nbytes, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "doppel_gather_rows")
    _build.count(gather_rows)
    return out


gather_rows.launches = 0


# ---------------------------------------------------------------- kernel D

def score_full_plain(rows_u8: torch.Tensor, w: torch.Tensor, sums: torch.Tensor,
                     maxint: torch.Tensor, nt: int, *, tb: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of kernel D after the gather: the (QB, ntp)
    Jaccard matrix of gathered rows (``gather_rows_plain``) and weights
    already rounded, in π column order, rounded to ``out_dtype``."""
    QB = w.shape[0]
    ntp = rows_u8.shape[1] * 8
    out = torch.empty((QB, ntp), dtype=out_dtype, device=rows_u8.device)
    for t0, jacc in _jaccard_chunks(rows_u8, w, sums, maxint, nt, tb, 1):
        n = jacc.shape[1]
        # tile-local title 8·b + s → column s·nb + b
        out[:, t0 : t0 + n] = jacc.reshape(QB, n // tb, tb // 8, 8).transpose(2, 3).reshape(QB, n)
    return out


def score_out_dtype(score_dtype: str) -> torch.dtype:
    """D's output type: bf16 scores when scoring in bf16, else f32."""
    return torch.bfloat16 if score_dtype == "bfloat16" else torch.float32


def score_full(packed: torch.Tensor, union_ids: torch.Tensor, w: torch.Tensor, sums: torch.Tensor,
               maxint: torch.Tensor, nt: int, *, tb: int, score_dtype: str) -> torch.Tensor:
    """The full Jaccard matrix of a query block over the union rows
    ``union_ids`` (U,) (repeats allowed, each in [0, V): the kernel reads
    ``packed[id]`` unchecked) of the packed index u8 (V, ntp/8):
    w f32 (QB, U), sums f32 (ntp,), maxint f32 (QB,) → (QB, ntp) in π
    column order, bf16 when ``score_dtype`` is bf16, else f32.  CPU tensors
    gather and score with the plain versions; CUDA tensors launch the
    kernel, which reads the union's rows straight from ``packed``."""
    if packed.dtype != torch.uint8 or packed.dim() != 2 or union_ids.dim() != 1:
        raise TypeError("kernel D takes a 2-D uint8 packed index and 1-D union ids")
    V, nbytes = packed.shape
    U = union_ids.shape[0]
    QB = w.shape[0]
    out_dtype = score_out_dtype(score_dtype)
    if w.dtype != torch.float32:
        raise TypeError("w must be float32")
    if w.shape[1] != U or sums.shape != (nbytes * 8,) or maxint.shape != (QB,):
        raise ValueError(f"shape mismatch: packed {tuple(packed.shape)}, union {U}, w "
                         f"{tuple(w.shape)}, sums {tuple(sums.shape)}, maxint {tuple(maxint.shape)}")
    if (nbytes * 8) % tb or tb % 8:
        raise ValueError(f"title count {nbytes * 8} / tile {tb} do not divide")
    if packed.device.type == "cpu":
        return score_full_plain(gather_rows_plain(packed, union_ids), round_weights(w, score_dtype),
                                sums, maxint, nt, tb=tb, out_dtype=out_dtype)
    if tb % 64 or nbytes % 16 or U == 0:
        raise ValueError(f"kernel D takes tiles of a multiple of 64 titles, rows of a multiple of "
                         f"16 bytes and a nonempty union, got tb={tb}, {nbytes} bytes, U={U}")
    if sums.dtype != torch.float32 or maxint.dtype != torch.float32:
        raise TypeError("sums and maxint must be float32")
    ids32 = union_ids.to(torch.int32).contiguous()
    img = kernel_a_weights(w, 1, score_dtype)
    dev = check_launch("kernel D", packed, ids32, img, sums, maxint)
    out = torch.empty((QB, nbytes * 8), dtype=out_dtype, device=dev)
    if QB == 0:
        return out
    with torch.cuda.device(dev):
        rc = _build.lib().doppel_score_full(
            packed.data_ptr(), ids32.data_ptr(), img.data_ptr(), sums.data_ptr(), maxint.data_ptr(),
            out.data_ptr(), img.shape[0], int(out_dtype == torch.bfloat16), QB, U, nbytes, tb,
            int(nt), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "doppel_score_full")
    _build.count(score_full)
    return out


score_full.launches = 0


def score_keys(jacc: torch.Tensor) -> torch.Tensor:
    """int64 keys (QB, ntp) of a π-ordered score matrix (f32 or bf16): the
    f32 bits of each score as an order-preserving int32 above the
    complement of its column, so keys are unique, a larger key is a higher
    score, and of equal scores the lower column has the larger key (the
    order the reference's blockwise ``lax.top_k`` merge gives)."""
    ntp = jacc.shape[1]
    bits = jacc.to(torch.float32).view(torch.int32)
    mono = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    low = 0xFFFFFFFF - torch.arange(ntp, device=jacc.device, dtype=torch.int64)
    return mono.to(torch.int64) * (1 << 32) + low[None, :]


def select_topk_keys(keys: torch.Tensor, k: int, tb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``score_keys`` keys (QB, n), any subset of a row's
    keys that holds its k largest: (vals f32 (QB, k), titles i32 (QB, k)),
    scores descending, ties to the lower column."""
    top = torch.topk(keys, k, dim=1).values
    mono = (top >> 32).to(torch.int32)
    vals = (mono ^ ((mono >> 31) & 0x7FFFFFFF)).view(torch.float32)
    cols = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return vals, unpermute_positions(cols, tb).to(torch.int32)


def select_topk_permuted(jacc: torch.Tensor, k: int, tb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a π-ordered score matrix (f32 or bf16), ties to the
    lower column, mapped back to titles: a plain top-k over the unique
    ``score_keys``.  Returns (vals f32 (QB, k), titles i32 (QB, k))."""
    return select_topk_keys(score_keys(jacc), k, tb)


def untied_slots(vals: torch.Tensor, eps: float) -> torch.Tensor:
    """bool (QB, k): top-k slots (scores sorted descending) whose score
    differs from both neighbours by more than ``eps``, so that no summation
    order can change the title there.  The last slot's successor is not
    seen, so it never counts.  Two top-k results are held to equal titles
    on these slots."""
    gap = (vals[:, :-1] - vals[:, 1:]) > eps
    sep = torch.zeros_like(vals, dtype=torch.bool)
    sep[:, 1:-1] = gap[:, :-1] & gap[:, 1:]
    sep[:, 0] = gap[:, 0]
    return sep


# ---------------------------------------------------------------- kernel E

def densify_weights(w_pos: torch.Tensor, w_val: torch.Tensor, union_size: int) -> torch.Tensor:
    """Sparse (positions into the union, values) → dense f32 (QB, U) weights:
    a set, not an add; position ``union_size`` is the padding slot (dropped)."""
    qb = w_pos.shape[0]
    w = torch.zeros((qb, union_size + 1), dtype=torch.float32, device=w_val.device)
    w.scatter_(1, w_pos.to(torch.int64), w_val.to(torch.float32))
    return w[:, :union_size].contiguous()


def jaccard_topk_v1_plain(packed, sums, union_ids, w_pos, w_val, maxint, nt, *, k: int, tb: int,
                          score_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel E."""
    w = round_weights(densify_weights(w_pos, w_val, union_ids.shape[0]), score_dtype)
    rows = gather_rows_plain(packed, union_ids)
    jacc = score_full_plain(rows, w, sums, maxint, nt, tb=tb, out_dtype=torch.float32)
    return select_topk_permuted(jacc, k, tb)


# kernel E: titles of a block's range, the most weight slots a query and the
# largest k it takes
_E_RANGE, _E_MAX_SLOTS, _E_MAX_K = 8192, 256, 1024


def jaccard_topk_v1(packed: torch.Tensor, sums: torch.Tensor, union_ids: torch.Tensor,
                    w_pos: torch.Tensor, w_val: torch.Tensor, maxint: torch.Tensor, nt: int,
                    *, k: int, tb: int, score_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's v1 retrieval step: packed u8 (V, ntp/8), sums f32
    (ntp,), union_ids (U,) row ids in [0, V) (repeats allowed; each
    position adds its row), w_pos (QB, LQ) positions into the union, U the
    padding slot, w_val f32 (QB, LQ), maxint f32 (QB,) → exact top-k
    (scores f32 (QB, k), titles i32 (QB, k)), ties to the lower π column,
    titles past ``nt`` at -1.  Scores are f32 whatever ``score_dtype``
    (which rounds the weights).  A query's positions must be distinct but
    for the padding slot, as the planner makes them: the plain version sets
    each position's weight, the kernel adds every slot.  CPU tensors take
    the plain version; CUDA tensors launch kernel E, which reads
    ``packed[id]`` unchecked and takes LQ ≤ 256, tiles tb of a power of two
    from 32 to 8,192 titles and k ≤ min(1,024, ntp)."""
    if packed.device.type == "cpu":
        return jaccard_topk_v1_plain(packed, sums, union_ids, w_pos, w_val, maxint, nt, k=k, tb=tb,
                                     score_dtype=score_dtype)
    if packed.dtype != torch.uint8 or packed.dim() != 2 or union_ids.dim() != 1 or w_pos.dim() != 2:
        raise TypeError("kernel E takes a 2-D uint8 packed index, 1-D union ids and 2-D w_pos")
    if score_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown score_dtype {score_dtype!r}")
    if w_val.dtype != torch.float32 or sums.dtype != torch.float32 or maxint.dtype != torch.float32:
        raise TypeError("w_val, sums and maxint must be float32")
    nbytes = packed.shape[1]
    ntp = nbytes * 8
    QB, LQ = w_pos.shape
    if w_val.shape != (QB, LQ) or sums.shape != (ntp,) or maxint.shape != (QB,):
        raise ValueError(f"shape mismatch: packed {tuple(packed.shape)}, w_pos {tuple(w_pos.shape)}, "
                         f"w_val {tuple(w_val.shape)}, sums {tuple(sums.shape)}, maxint "
                         f"{tuple(maxint.shape)}")
    if (tb < 32 or tb > _E_RANGE or tb & (tb - 1) or ntp % tb or not 1 <= k <= min(_E_MAX_K, ntp)
            or LQ > _E_MAX_SLOTS):
        raise ValueError(f"kernel E takes tiles of a power of two from 32 to {_E_RANGE} titles that "
                         f"divide the titles, 1 <= k <= min({_E_MAX_K}, titles) and at most "
                         f"{_E_MAX_SLOTS} slots a query, got tb={tb}, {ntp} titles, k={k}, LQ={LQ}")
    ids32 = union_ids.to(torch.int32).contiguous()
    pos32 = w_pos.to(torch.int32).contiguous()
    dev = check_launch("kernel E", packed, ids32, pos32, w_val, sums, maxint)
    vals = torch.empty((QB, k), dtype=torch.float32, device=dev)
    titles = torch.empty((QB, k), dtype=torch.int32, device=dev)
    if QB == 0:
        return vals, titles
    # each title range's top-k keys, and the query's floor under its k-th key
    keys = torch.empty((QB, -(-ntp // _E_RANGE) * k), dtype=torch.int64, device=dev)
    floor = torch.full((QB,), torch.iinfo(torch.int64).min, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().doppel_score_sparse_topk(
            packed.data_ptr(), ids32.data_ptr(), pos32.data_ptr(), w_val.data_ptr(), sums.data_ptr(),
            maxint.data_ptr(), keys.data_ptr(), floor.data_ptr(), vals.data_ptr(), titles.data_ptr(),
            QB, ids32.shape[0], LQ, nbytes, int(nt), tb, k, int(score_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "doppel_score_sparse_topk")
    _build.count(jaccard_topk_v1)
    return vals, titles


jaccard_topk_v1.launches = 0


# ------------------------------------------------------- graph bookkeeping

def launch_counters():
    """(kernel wrapper, counter) of every launch count, B's, F's and G's
    too (G's wrapper lives in ``ops/fold.py``, which imports this module)."""
    from doppelspeller_tpu_torch.ops import fold

    return [(score_window_select, "launches"), (score_window_select, "gathered"),
            (gather_rows, "launches"), (score_full, "launches"),
            (jaccard_topk_v1, "launches"), (fk.window_best, "launches"), (lev.lcs, "launches"),
            (fold.select_rescore, "launches")]


def uncounted(capture):
    """``capture()``, a CUDA graph capture, in which the wrappers count
    launches that do not happen; no other thread may launch meanwhile.
    Returns (its result, the launches one replay makes, by counter), the
    capture's counts taken back off."""
    counters = launch_counters()
    before = [getattr(fn, attr) for fn, attr in counters]
    launches = []
    try:
        out = capture()
    finally:
        for (fn, attr), b in zip(counters, before):
            launches.append(getattr(fn, attr) - b)
            setattr(fn, attr, b)
    return out, launches


def count_replay(launches) -> None:
    """Add one replay's launches (from ``uncounted``) to the counts."""
    for (fn, attr), n in zip(launch_counters(), launches):
        if n:
            _build.count(fn, attr, n)
