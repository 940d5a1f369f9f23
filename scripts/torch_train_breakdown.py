"""Where the PyTorch port's training time goes on the card, and whether two
trainings there give the same trees.

    python scripts/torch_train_breakdown.py

Builds the bench's synthetic world (500k titles, seed 7) and, on its first
50,000 titles, the training rows of ``synthetic.quick_train_model``.  Then:

1. trains five times with ``quick_train_model`` (60 rounds) and prints
   each run's timings and how many trees are equal to the first run's
   (the histograms add in fixed point, so every tree should be); once
   more with
   ``retrieval_window_select`` off, so the candidates are the full top-100
   (kernel D) and not one per window of 16 titles (kernel A), and twice
   with another ``seed`` (other sampled candidates, another evaluation
   split); then predicts the world's 16,384 queries (folded retrieval) with
   each model and with the committed one and prints the accuracies;
2. runs the feature matrix once more under ``torch.profiler`` and prints the
   device time beside the wall time and the top kernels;
3. runs one 10-round boosting segment under the profiler, the same way, and
   times a level histogram alone with CUDA events three ways at the same
   keys: in fixed point as training sums (int64 ``index_add_``, then the
   conversion to f32), as f32 ``index_add_`` (atomics, whose order changes
   the sums from run to run), and in row order (``index_put_`` with
   ``accumulate``: a stable sort, then each segment in order).

Needs one CUDA card; prints the card's name and power limit first.
"""

import os
import random
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def profiled(torch, label, fn, top=8):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.time() - t
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append((us / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    total = sum(k[0] for k in kernels)
    n = sum(k[1] for k in kernels)
    print(f"# {label}: {total:.1f} ms of kernel time in {n} launches, {wall * 1e3:.1f} ms wall "
          f"under the profiler (its overhead included)", flush=True)
    for ms, count, key in kernels[:top]:
        print(f"#   {ms:9.2f} ms {100 * ms / max(total, 1e-9):5.1f} % x{count:<6d} {key[:90]}", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_train_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.models import gbt, trainer
    from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
    from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
    from doppelspeller_tpu_torch.synthetic import (make_synthetic_world, quick_train_model,
                                                   quick_train_rows)

    cfg0 = Config(data_path=os.path.join(ROOT, "data"))
    t = time.time()
    cfg, truth, queries, actual = make_synthetic_world(500_000, 16_384, seed=7, config=cfg0)
    print(f"# world: {time.time() - t:.1f} s", flush=True)

    # ---- 1. the trainings ----
    models = []
    for run in (1, 2, 3, 4, 5):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        model, report = quick_train_model(cfg, truth, 60, "cuda")
        torch.cuda.synchronize()
        print(f"# training {run}: {time.time() - t:.3f} s, timings "
              f"{ {k: round(v, 3) for k, v in report['timings'].items()} }, eval error "
              f"{report['history']['eval_error'][-1]:.1f}, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
        models.append(model)
    t = time.time()
    full, _ = quick_train_model(cfg.with_(retrieval_window_select=False), truth, 60, "cuda")
    torch.cuda.synchronize()
    print(f"# training with the full top-100 (window select off): {time.time() - t:.3f} s", flush=True)
    seeded = [(f"training with seed {sd}", quick_train_model(cfg.with_(seed=sd), truth, 60, "cuda")[0])
              for sd in (1, 2)]
    for run, b in enumerate(models[1:], 2):
        a = models[0]
        same = [all(np.array_equal(getattr(a, k)[i], getattr(b, k)[i])
                    for k in ("feat", "split_bin", "missing_left", "is_leaf"))
                for i in range(a.num_trees)]
        print(f"# training {run} against training 1: {sum(same)} of {len(same)} trees equal in "
              f"structure; values equal bit for bit: {bool(np.array_equal(a.value, b.value))}",
              flush=True)
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher

    committed = GBTModel.load(os.path.join(ROOT, "doppelspeller_tpu_torch", "assets",
                                           "bench_model_r60.npz"))
    matcher = Matcher(cfg, truth, committed, device="cuda")
    for label, m in ([("committed model", committed), ("training on the full top-100", full)]
                     + seeded + [(f"training {i}", m) for i, m in enumerate(models, 1)]):
        matcher.set_model(m)
        res = matcher.predict(queries)
        print(f"# folded predict, {label}: accuracy {float((res.match_title_id == actual).mean()):.4f}, "
              f"stage_counts {res.stage_counts}", flush=True)
    del matcher
    torch.cuda.empty_cache()

    # ---- 2. the feature matrix ----
    small, train = quick_train_rows(cfg, truth)
    scorer = JaccardScorer(build_truth_index(small, cfg), cfg, "cuda")
    t = time.time()
    pairs = trainer.assemble_training_pairs(train, small, scorer, cfg, random.Random(cfg.seed))
    torch.cuda.synchronize()
    print(f"# pairs: {len(pairs.kind)} in {time.time() - t:.3f} s", flush=True)
    t = time.time()
    _, cand = scorer.topk(train, k=cfg.top_n_predicting)
    print(f"# of which retrieval of 2,000 rows alone: {time.time() - t:.3f} s", flush=True)
    wc = trainer.WordCounts(small)
    t = time.time()
    wc.matrix(small.transformed)
    print(f"# word-count matrix of 50,000 titles (host): {time.time() - t:.3f} s", flush=True)
    X = profiled(torch, "feature matrix",
                 lambda: trainer.build_feature_matrix(pairs, wc, small, cfg, "cuda"))

    # ---- 3. one boosting segment ----
    y = pairs.target
    t = time.time()
    edges = gbt.compute_bin_edges(X)
    bins = gbt.bin_features(X, edges)
    print(f"# bin edges and bins of {X.shape} on the host: {time.time() - t:.3f} s", flush=True)
    dev = torch.device("cuda")
    bins_d = torch.from_numpy(bins).to(dev)
    y_d = torch.from_numpy(y).to(dev)
    w = torch.ones(len(y), device=dev)
    m0 = torch.zeros(len(y), device=dev)
    kw = dict(depth=5, eta=0.1, beta=5.0, threshold=0.9, lambda_=1.0, min_child_weight=1.0)
    gbt.boost_segment([bins_d], y_d, w, w, 1.0 - w, m0, n_rounds=2, **kw)
    torch.cuda.synchronize()
    t = time.time()
    gbt.boost_segment([bins_d], y_d, w, w, 1.0 - w, m0, n_rounds=10, **kw)
    torch.cuda.synchronize()
    print(f"# boosting: 10 rounds on {tuple(bins_d.shape)} in {time.time() - t:.3f} s", flush=True)
    profiled(torch, "boosting, 10 rounds",
             lambda: gbt.boost_segment([bins_d], y_d, w, w, 1.0 - w, m0, n_rounds=10, **kw))
    N, F = bins_d.shape
    g = torch.randn(N, device=dev)
    for n_nodes in (1, 16):
        node = torch.randint(0, n_nodes, (N,), device=dev)
        key = (node[:, None] * (F * 256) + bins_d.to(torch.int64)
               + torch.arange(F, device=dev)[None, :] * 256).reshape(-1)
        src = g[:, None].expand(N, F).reshape(-1)
        n_seg = n_nodes * F * 256 + 1

        def timed(fn):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            fn()
            start.record()
            for _ in range(10):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 10

        (gq,), unit = gbt._quantize([g], N * F)
        srcq = gq[:, None].expand(N, F).reshape(-1)
        fixed = timed(lambda: gbt._segment_sum([key], [srcq], unit, n_seg))
        atomics = timed(lambda: torch.zeros(n_seg, device=dev).index_add_(0, key, src))
        ordered = timed(lambda: torch.zeros(n_seg, device=dev).index_put_((key,), src, accumulate=True))
        print(f"# level histogram of {N * F} keys into {n_nodes} node(s) x {F} x 256 bins: "
              f"fixed point (int64 index_add_) {fixed:.3f} ms; f32 index_add_ (atomics) "
              f"{atomics:.3f} ms; summed in row order (index_put_, accumulate) {ordered:.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
