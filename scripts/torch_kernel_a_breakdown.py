"""Split kernel A's time on the card (PyTorch port, NVIDIA Hopper).

    python scripts/torch_kernel_a_breakdown.py

Builds variants of ``doppelspeller_tpu_torch/csrc/score_window.cu`` into
``build/kernel_a_breakdown/`` and times each at the main path's shapes
(QB=128: folds=2, U=1,024, 524,288 titles; folds=1, U=3,072, 163,840 titles),
with bf16 and with f32 weights:

- ``base``: the kernel as committed;
- ``no_epilogue``: the block ends after the contraction (no Jaccard, no
  window max, no stores);
- ``no_mma``: the wgmmas are left out (loads, barriers and the bit unpack
  stay);
- ``no_mma_no_epilogue``: both left out: what the pipeline skeleton costs;
- ``zero_fill_weights``: the weight copies are zero fills that read nothing
  from memory;
- ``ieee_div``: the epilogue divides with the compiler's IEEE division;
- ``clock``: the base kernel with ``clock64`` stamps; warp 0 of every block
  records the cycles of its contraction and of its epilogue.

The variants are patched from the committed source, with the shared header
``csrc/wgmma_bits.cuh`` written in place of its ``#include``, by exact text
replacement, and the script stops if a pattern is missing.  Their outputs
are not checked (most are wrong by design).  Times are milliseconds per
launch over 20 back-to-back launches, by CUDA events.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "kernel_a_breakdown")


def patch(src, old, new):
    if src.count(old) != 1:
        raise SystemExit(f"pattern not found once in score_window.cu and wgmma_bits.cuh: "
                         f"{old[:60]!r}")
    return src.replace(old, new)


def variant_sources(src):
    """{variant: (source text, extra nvcc flags)}."""
    mma = ("        wgmma_rs(acc[acc0 + mt], a[ks][mt], b_desc(w_stage + p * kWTile * 2 + ks * 2 * 2048),\n"
           "                 !first || ks > 0 || p > 0);")
    src = patch(src, mma, "#ifndef NO_MMA\n" + mma + """
#else
          { asm volatile("" :: "r"(a[ks][mt][0]), "r"(a[ks][mt][1]), "r"(a[ks][mt][2]), "r"(a[ks][mt][3]));
            acc[acc0 + mt][p] += 1.f; }
#endif""")
    src = patch(src, "  // epilogue, per window", """#ifdef NO_EPILOGUE
  { float t = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) t += acc[0][i] + acc[1][i];
    if (t == 1234.5f) wmax[0] = t;
    return; }
#endif
  // epilogue, per window""")
    src = patch(src, "cp_async<16>(smem_addr(dst + i * 8), src + i * 8, true);",
                "cp_async<16>(smem_addr(dst + i * 8), src + i * 8, LOAD_WEIGHTS);")
    src = "#ifndef LOAD_WEIGHTS\n#define LOAD_WEIGHTS true\n#endif\n" + src
    src = patch(src, '  float r;\n  asm("rcp', '#ifdef IEEE_DIV\n  return n / d;\n#endif\n  float r;\n  asm("rcp')
    clock = patch(src, "  const int tid = threadIdx.x;", "  const int tid = threadIdx.x;\n  long long t_start = clock64();")
    clock = patch(clock, "  cp_async_wait<0>();\n", "  cp_async_wait<0>();\n  long long t_mainloop = clock64();\n")
    clock = patch(clock, "  }\n}\n\ntemplate <int P, int FOLDS>\ncudaError_t launch(", """  }
  if (tid == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    g_clock[2 * b] = t_mainloop - t_start;
    g_clock[2 * b + 1] = clock64() - t_mainloop;
  }
}

template <int P, int FOLDS>
cudaError_t launch(""")
    clock = patch(clock, "namespace {\n", "namespace {\n__device__ long long g_clock[2 * 8192];\n")
    clock += ('\nextern "C" int read_clock(void* host) '
              '{ return (int)cudaMemcpyFromSymbol(host, g_clock, sizeof(g_clock)); }\n')
    return {"base": (src, []), "no_epilogue": (src, ["-DNO_EPILOGUE"]), "no_mma": (src, ["-DNO_MMA"]),
            "no_mma_no_epilogue": (src, ["-DNO_MMA", "-DNO_EPILOGUE"]),
            "zero_fill_weights": (src, ["-DLOAD_WEIGHTS=false"]), "ieee_div": (src, ["-DIEEE_DIV"]),
            "clock": (clock, [])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_a_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from doppelspeller_tpu_torch import _build
    from doppelspeller_tpu_torch.ops import jaccard_kernels as jk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(_build.CSRC, "score_window.cu")) as f:
        src = f.read()
    with open(os.path.join(_build.CSRC, "wgmma_bits.cuh")) as f:
        src = patch(src, '#include "wgmma_bits.cuh"\n', f.read())
    variants = variant_sources(src)
    procs = {}
    for name, (text, flags) in variants.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                                        os.path.join(OUT, f"lib{name}.so"), path],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fns, libs = {}, {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{err}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        fn = libs[name].doppel_score_window_select
        fn.argtypes = _build._SIGNATURES["doppel_score_window_select"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def ms(call, reps=20):
        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    g = torch.Generator(device="cuda").manual_seed(7)
    qb, tb = 128, 2048
    for folds, U, ntp, nt in ((2, 1024, 524_288, 500_000), (1, 3072, 163_840, 150_000)):
        rows = (torch.rand((U, ntp), device="cuda", generator=g) < 0.06)
        rows = (rows.view(U, ntp // 8, 8).to(torch.uint8)
                << torch.arange(8, device="cuda", dtype=torch.uint8)).sum(dim=2, dtype=torch.uint8)
        w = torch.rand((qb, U), device="cuda", generator=g) * 10.0
        sums = torch.rand(ntp, device="cuda", generator=g) * 60.0 + 20.0
        maxint = w.sum(dim=1)
        wmax = torch.empty((qb, ntp // 16), device="cuda")
        warg = torch.empty((qb, ntp // 16), device="cuda", dtype=torch.int32)
        stream = torch.cuda.current_stream().cuda_stream
        for dt in ("bfloat16", "float32"):
            img = jk.kernel_a_weights(w, folds, dt)
            res = {}
            for name, fn in fns.items():
                def call(fn=fn):
                    rc = fn(rows.data_ptr(), img.data_ptr(), sums.data_ptr(), maxint.data_ptr(),
                            wmax.data_ptr(), warg.data_ptr(), qb, U // folds, folds, ntp // 8,
                            img.shape[0], ntp // tb, nt, stream)
                    _build.check(rc, name)
                res[name] = ms(call)
            res["wrapper (image + base)"] = ms(lambda: jk.score_window_select(
                rows, w, sums, maxint, nt, tb=tb, W=16, folds=folds, score_dtype=dt))
            print(f"folds={folds}, U={U}, {ntp} titles, {dt}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in res.items()), flush=True)
            clock = np.zeros(2 * 8192, np.int64)
            _build.check(libs["clock"].read_clock(ctypes.c_void_p(clock.ctypes.data)), "read_clock")
            groups = 128 // (8 * (2 // folds))
            n_blocks = (ntp // tb) * groups
            cyc = clock[: 2 * n_blocks].reshape(n_blocks, 2)
            live = (np.arange(n_blocks) // groups) * tb < nt       # tiles past nt skip both
            print(f"  clock64, warp 0 of {int(live.sum())} blocks: contraction median "
                  f"{np.median(cyc[live, 0]):.0f} cycles (p10 {np.percentile(cyc[live, 0], 10):.0f}, "
                  f"p90 {np.percentile(cyc[live, 0], 90):.0f}); epilogue median "
                  f"{np.median(cyc[live, 1]):.0f} (p90 {np.percentile(cyc[live, 1], 90):.0f})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
