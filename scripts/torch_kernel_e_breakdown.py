"""Split kernel E's time on the card (PyTorch port, NVIDIA Hopper).

    python scripts/torch_kernel_e_breakdown.py

Builds variants of ``doppelspeller_tpu_torch/csrc/score_sparse_topk.cu``
into ``build/kernel_e_breakdown/`` and times each at the smoke's block
(``chip_smoke.union_inputs``: QB=128, U=3,072, LQ=64, 524,288 titles,
k=100, f32), in alternating windows (``chip_smoke.alternating_ms``):

- ``wrapper``: ``jaccard_topk_v1`` as the path calls it;
- ``base``: the committed entry alone (both kernels, no wrapper);
- ``past_nt``: the same with nt = 0: no range is scored, so the first
  kernel skips the contraction and selects among titles that all tie;
- ``no_select``: the first kernel ends each query after its scores (no
  floors, no selection, no writes), then the merge;
- ``merge_only``: the entry launches the merge alone, over the keys the
  last ``base`` call left and a floor that takes every key.

The variants are patched from the committed source by exact text
replacement, and the script stops if a pattern is missing.  Their outputs
are not checked (most are wrong by design).
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "kernel_e_breakdown")


def patch(src, old, new):
    if src.count(old) != 1:
        raise SystemExit(f"pattern not found once in score_sparse_topk.cu: {old[:60]!r}")
    return src.replace(old, new)


def variant_sources(src):
    a = src.index("    // the floors: each warp's")
    b = src.index("    __syncthreads();   // the candidates, s_cnt and s_out are the next query's")
    no_select = (src[:a] + "    { uint32_t x = 0;\n      for (int j = 0; j < 32; ++j) x ^= hi[j];\n"
                 "      if (x == 12345u) out[tid] = x; }\n" + src[b:])
    merge_only = patch(src, "  score_sparse_topk_kernel<<<grid, kThreads, kDynSmem, st>>>(",
                       "  if (false) score_sparse_topk_kernel<<<grid, kThreads, kDynSmem, st>>>(")
    return {"no_select": no_select, "merge_only": merge_only}


def main():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from doppelspeller_tpu_torch import _build
    from doppelspeller_tpu_torch.ops import jaccard_kernels as jk

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(OUT, exist_ok=True)
    src = open(os.path.join(_build.CSRC, "score_sparse_topk.cu")).read()
    entry = _build._SIGNATURES["doppel_score_sparse_topk"][1]
    fns = {"base": _build.lib().doppel_score_sparse_topk}
    procs = {}
    for name, text in variant_sources(src).items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
             os.path.join(OUT, f"lib{name}.so"), path], stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        fn = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")).doppel_score_sparse_topk
        fn.argtypes, fn.restype = entry, ctypes.c_int
        fns[name] = fn

    d = chip_smoke.union_inputs(torch)
    packed, ids, w_pos, w_val, sums, maxint, nt, tb = (
        d[key] for key in ("packed", "union_ids", "w_pos", "w_val", "sums", "maxint", "nt", "tb"))
    qb, lq = w_pos.shape
    k = 100
    keys = torch.empty((qb, -(-packed.shape[1] * 8 // 8192) * k), dtype=torch.int64, device="cuda")
    floor = torch.empty(qb, dtype=torch.int64, device="cuda")
    vals = torch.empty((qb, k), dtype=torch.float32, device="cuda")
    titles = torch.empty((qb, k), dtype=torch.int32, device="cuda")

    def launch(fn, n_real):
        def call():
            floor.fill_(torch.iinfo(torch.int64).min)
            rc = fn(packed.data_ptr(), ids.data_ptr(), w_pos.data_ptr(), w_val.data_ptr(),
                    sums.data_ptr(), maxint.data_ptr(), keys.data_ptr(), floor.data_ptr(),
                    vals.data_ptr(), titles.data_ptr(), qb, ids.shape[0], lq, packed.shape[1],
                    n_real, tb, k, 0, torch.cuda.current_stream().cuda_stream)
            _build.check(rc, "doppel_score_sparse_topk")
        return call

    timed = {"wrapper": lambda: jk.jaccard_topk_v1(packed, sums, ids, w_pos, w_val, maxint, nt, k=k,
                                                   tb=tb, score_dtype="float32"),
             "past_nt": launch(fns["base"], 0), "no_select": launch(fns["no_select"], nt),
             "base": launch(fns["base"], nt), "merge_only": launch(fns["merge_only"], nt)}
    ms = chip_smoke.alternating_ms(timed, rounds=7)
    print(json.dumps({"card": smi, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
