"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its seconds; any failure exits non-zero:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles the port's CUDA kernels from ``doppelspeller_tpu_torch/csrc``.
3. kernel A (folded coarse scoring with window select) against its plain
   PyTorch version at the main path's shapes (QB=128, U=1024, folds=2,
   524,288 titles, tb=2048, W=16), in f32 and in bf16.
4. kernel B (sliding-window LCS) against its plain version at model-stage
   shapes (65,536 pairs, TL=64, WL=16 and 32): exactly equal.
5. small world: the port on the card against the port's plain CPU path
   (the path the CPU tests hold equal to the JAX package) on a 4,096-title
   world, f32 scoring.
6. main path: 500,000 titles x 16,384 queries (the bench world, seed 7),
   the committed 60-tree model, default Config (folded two-hash retrieval,
   bf16 coarse weights, adaptive model depth); one untimed and one timed
   ``Matcher.predict``; both kernels must have launched in the timed run,
   every stage must match rows and accuracy must reach 0.80.

The line before the last is a JSON object with every kernel's route,
source, launches in the timed run, error and times; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(ROOT, "doppelspeller_tpu_torch", "assets", "bench_model_r60.npz")

N_TITLES, N_QUERIES, SEED = 500_000, 16_384, 7
ACCURACY_FLOOR = 0.80


def phase(name, t0):
    print(f"# phase {name}: {time.time() - t0:.3f} s", flush=True)


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernel_a(torch, jk):
    rng = torch.Generator(device="cuda").manual_seed(SEED)
    qb, C, folds, ntp, nt, tb, W = 128, 512, 2, 524_288, 500_000, 2048, 16
    U = folds * C
    rows = (torch.rand((U, ntp), device="cuda", generator=rng) < 0.06)
    rows = (rows.view(U, ntp // 8, 8).to(torch.uint8)
            << torch.arange(8, device="cuda", dtype=torch.uint8)).sum(dim=2, dtype=torch.uint8)
    w = torch.rand((qb, U), device="cuda", generator=rng) * 10.0
    w = torch.where(torch.rand((qb, U), device="cuda", generator=rng) < 0.94, torch.zeros_like(w), w)
    sums = torch.rand(ntp, device="cuda", generator=rng) * 60.0 + 20.0
    sums[nt:] = 0.0
    maxint = torch.rand(qb, device="cuda", generator=rng) * 60.0 + 20.0
    out = {}
    for dt in ("float32", "bfloat16"):
        wk, ak = jk.score_window_select(rows, w, sums, maxint, nt, tb=tb, W=W, folds=folds,
                                        score_dtype=dt)
        wr = jk.round_weights(w, dt)
        wp, ap = jk.score_window_select_plain(rows, wr, sums, maxint, nt, tb=tb, W=W, folds=folds)
        torch.cuda.synchronize()
        err = float((wk - wp).abs().max())
        if dt == "float32":
            torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-7)
            # titles must agree wherever the window's best two offsets are not tied
            bits = ((rows[:, :, None] >> torch.arange(8, device="cuda", dtype=torch.uint8)) & 1)
            bits = bits.reshape(U, ntp).float()
            num = torch.minimum(w[:, :C] @ bits[:C], w[:, C:] @ bits[C:])
            jacc = num / torch.clamp((sums[None] + maxint[:, None]) - num, min=1e-9)
            jacc = torch.where(torch.arange(ntp, device="cuda")[None] < nt, jacc, torch.full_like(jacc, -1.0))
            local = jk.window_titles(tb, W, "cuda")
            jw = jacc.reshape(qb, ntp // tb, tb)[:, :, local]             # (qb, tiles, W, S)
            top2 = jw.topk(2, dim=2).values
            untied = (top2[:, :, 0] - top2[:, :, 1] > 1e-6 * top2[:, :, 0].abs()).reshape(qb, -1)
            if not torch.equal(ak[untied], ap[untied]):
                raise AssertionError("kernel A window titles differ from the plain version")
            print(f"# kernel A f32: max |wmax err| {err:.3e} (rtol 1e-5); titles equal on "
                  f"{int(untied.sum())}/{untied.numel()} untied windows", flush=True)
            out["max_abs_err"] = err
            out["ms"] = cuda_ms(lambda: jk.score_window_select(
                rows, w, sums, maxint, nt, tb=tb, W=W, folds=folds, score_dtype="float32"))
            out["plain_ms"] = cuda_ms(lambda: jk.score_window_select_plain(
                rows, w, sums, maxint, nt, tb=tb, W=W, folds=folds))
        else:
            if err > 1e-2:
                raise AssertionError(f"kernel A bf16 max |wmax err| {err} > 1e-2")
            print(f"# kernel A bf16: max |wmax err| {err:.3e} (atol 1e-2)", flush=True)
            out["ms_bf16"] = cuda_ms(lambda: jk.score_window_select(
                rows, w, sums, maxint, nt, tb=tb, W=W, folds=folds, score_dtype="bfloat16"))
    print(f"# kernel A: {out['ms']:.3f} ms (bf16 {out['ms_bf16']:.3f} ms), plain "
          f"{out['plain_ms']:.3f} ms per 128-query block", flush=True)
    return out


def check_kernel_b(torch, fk):
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, W, TL = 2048 * 32, 15, 64
    out = {"max_abs_err": 0.0}
    for WL in (16, 32):
        q_wo = torch.randint(2, 12, (B, TL), device="cuda", generator=g, dtype=torch.int32)
        q_wo_len = torch.randint(1, TL + 1, (B,), device="cuda", generator=g, dtype=torch.int32)
        q_wo = torch.where(torch.arange(TL, device="cuda")[None] < q_wo_len[:, None], q_wo, 0).to(torch.uint8)
        wlen = torch.randint(0, WL + 1, (B, W), device="cuda", generator=g, dtype=torch.int32)
        wlen[:, 5:] = 0
        chars = torch.randint(2, 12, (B, W, WL), device="cuda", generator=g, dtype=torch.int32)
        chars = torch.where(torch.arange(WL, device="cuda")[None, None] < wlen[:, :, None], chars, 0)
        args = (chars.to(torch.uint8).contiguous(), wlen, q_wo.contiguous(), q_wo_len)
        rk, pk = fk.window_best(*args)
        rp, pp = fk.window_best_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(rk, rp) and torch.equal(pk, pp)):
            raise AssertionError(f"kernel B differs from the plain version at WL={WL}")
        ms = cuda_ms(lambda: fk.window_best(*args))
        plain = cuda_ms(lambda: fk.window_best_plain(*args))
        print(f"# kernel B WL={WL}: exactly equal; {ms:.3f} ms, plain {plain:.3f} ms "
              f"({B} pairs x {W} words, TL={TL})", flush=True)
        out[f"ms_wl{WL}"], out[f"plain_ms_wl{WL}"] = ms, plain
    out["ms"], out["plain_ms"] = out["ms_wl32"], out["plain_ms_wl32"]
    return out


def main() -> int:
    t0 = time.time()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}; {kind}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from doppelspeller_tpu_torch import _build
    from doppelspeller_tpu_torch.ops import features_kernels as fk
    from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
    phase("device", t0)

    t = time.time()
    path = _build.build()
    _build.lib()
    print(f"# built {os.path.relpath(path, ROOT)} in {_build.BUILD_SECONDS or 0.0:.1f} s", flush=True)
    phase("build", t)

    t = time.time()
    ka = check_kernel_a(torch, jk)
    phase("kernel_a", t)
    t = time.time()
    kb = check_kernel_b(torch, fk)
    phase("kernel_b", t)

    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world

    model = GBTModel.load(MODEL)
    cfg0 = Config(data_path=os.path.join(ROOT, "data"))

    # ---- small world: card vs the plain CPU path ----
    t = time.time()
    cfg_s = cfg0.with_(retrieval_mode="folded", score_dtype="float32")
    _, truth_s, queries_s, _ = make_synthetic_world(4096, 512, seed=SEED, config=cfg_s)
    r_cpu = Matcher(cfg_s, truth_s, model, device="cpu").predict(queries_s)
    r_gpu = Matcher(cfg_s, truth_s, model, device="cuda").predict(queries_s)
    same = (r_cpu.match_title_id == r_gpu.match_title_id) & (r_cpu.stage == r_gpu.stage)
    print(f"# small world: card agrees with the plain CPU path on {int(same.sum())}/{len(same)} "
          f"rows (tolerance: 99 %); max |pred diff| "
          f"{float(abs(r_cpu.prediction - r_gpu.prediction)[same].max()):.2e}", flush=True)
    if same.mean() < 0.99:
        raise AssertionError("card and plain CPU path disagree on the small world")
    phase("small_world", t)

    # ---- main path ----
    t = time.time()
    cfg, truth, queries, actual = make_synthetic_world(N_TITLES, N_QUERIES, seed=SEED, config=cfg0)
    phase("world", t)
    t = time.time()
    matcher = Matcher(cfg, truth, model, device="cuda")
    torch.cuda.synchronize()
    phase("matcher_init", t)
    t = time.time()
    matcher.predict(queries)
    torch.cuda.synchronize()
    phase("predict_untimed", t)

    jk.score_window_select.launches = 0
    fk.window_best.launches = 0
    t = time.time()
    res = matcher.predict(queries)
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = {"a": jk.score_window_select.launches, "b": fk.window_best.launches}
    phase("predict_timed", t)
    accuracy = float((res.match_title_id == actual).mean())
    print(f"# predict: {N_QUERIES} queries x {N_TITLES} titles in {dt:.3f} s = "
          f"{N_QUERIES / dt:.1f} q/s, accuracy {accuracy:.4f}", flush=True)
    print(f"# stage_counts {json.dumps(res.stage_counts)}", flush=True)
    print(f"# stage_seconds {json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()})}",
          flush=True)
    print(f"# launches in the timed predict: kernel A {launches['a']}, kernel B {launches['b']}",
          flush=True)
    if res.match_title_id.shape != (N_QUERIES,) or not bool((res.prediction >= 0).all()):
        raise AssertionError("malformed prediction result")
    if not all(res.stage_counts[s] > 0 for s in ("exact", "fuzzy", "model")):
        raise AssertionError(f"a stage matched no rows: {res.stage_counts}")
    if launches["a"] == 0 or launches["b"] == 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    if accuracy < ACCURACY_FLOOR:
        raise AssertionError(f"accuracy {accuracy:.4f} < {ACCURACY_FLOOR}")

    kernels = [
        {"name": "score_window_select", "route": "cuda",
         "source": "doppelspeller_tpu_torch/csrc/score_window.cu",
         "replaces": "doppelspeller_tpu/ops/jaccard_pallas.py:263",
         "launches": launches["a"], "max_abs_err": ka["max_abs_err"],
         "ms": ka["ms"], "plain_ms": ka["plain_ms"]},
        {"name": "window_best", "route": "cuda",
         "source": "doppelspeller_tpu_torch/csrc/window_lcs.cu",
         "replaces": "doppelspeller_tpu/ops/features_pallas.py:53",
         "launches": launches["b"], "max_abs_err": kb["max_abs_err"],
         "ms": kb["ms"], "plain_ms": kb["plain_ms"]},
    ]
    phase("total", t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
