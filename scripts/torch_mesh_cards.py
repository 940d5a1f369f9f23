"""The title-sharded mesh over every card of a host (PyTorch port).

    python scripts/torch_mesh_cards.py [reps] [profile_dir]

On ``make_mesh()`` (all the host's cards, one shard each) against one
card, on the smoke's worlds (``synthetic.make_synthetic_world``, seed 7,
16,384 queries, the committed 60-tree model, default config):

- exact, 150,000 titles: ``Matcher(mesh=)`` construction seconds, one
  untimed predict each, then ``reps`` (default 3) rounds of timed predicts
  in turns (one card, mesh, mesh, one card), each ended by a synchronize of
  every card; the mesh's top-100 and predictions must equal the single
  card's bit for bit;
- folded, 500,000 titles: the same, accuracy within 0.01 of one card's;
- training: ``train_model(mesh=)`` on ``synthetic.quick_train_rows`` with 60
  rounds against one card: every tree equal bit for bit;
- with ``profile_dir``, last (a profiler session slows what runs after it):
  one more predict of each world on one card and on the mesh under
  ``torch.profiler`` (host and device activity): each card's busy
  milliseconds (kernels and copies), the count and host milliseconds of
  the runtime's launch, copy and synchronize calls and of the operators
  that wait on the device, and the whole operator table, by host time,
  written to ``profile_dir/<world>_<one|mesh>.txt``.

Prints each card's name and power limit, then one JSON line of every
time.  Needs CUDA; a machine of one card runs a mesh of one.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "doppelspeller_tpu_torch", "assets", "bench_model_r60.npz")
N_QUERIES, SEED, ROUNDS = 16_384, 7, 60
TREE_FIELDS = ("feat", "split_bin", "missing_left", "value", "is_leaf", "threshold")
# host calls that launch, copy or wait on a card
HOST_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync", "cudaMemsetAsync",
              "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaStreamWaitEvent", "cudaEventRecord", "aten::nonzero", "aten::item",
              "aten::_local_scalar_dense", "aten::copy_")


def profile_predict(torch, matcher, queries, devices, path):
    """One ``matcher.predict(queries)`` under torch.profiler (host and device
    activity).  Returns the profiled wall seconds, each card's busy
    milliseconds and the ``HOST_CALLS`` seen (count, self host ms); writes
    the operator table by self host time to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    for d in devices:
        torch.cuda.synchronize(d)
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        matcher.predict(queries)
        for d in devices:
            torch.cuda.synchronize(d)
    wall = time.time() - t
    busy = {}
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            busy[ev.device_index] = busy.get(ev.device_index, 0.0) + ev.time_range.elapsed_us() / 1e3
    table = prof.key_averages()
    host = {ev.key: {"count": ev.count, "self_host_ms": ev.self_cpu_time_total / 1e3}
            for ev in table if ev.key in HOST_CALLS}
    with open(path, "w") as f:
        f.write(table.table(sort_by="self_cpu_time_total", row_limit=60))
    return {"wall_s": wall, "device_busy_ms": {f"cuda:{k}": v for k, v in sorted(busy.items())},
            "host_calls": host}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_cards: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.models.gbt import GBTModel, GBTParams
    from doppelspeller_tpu_torch.models.trainer import train_model
    from doppelspeller_tpu_torch.parallel.sharded import make_mesh
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world, quick_train_rows

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    profile_dir = sys.argv[2] if len(sys.argv) > 2 else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh()
    model = GBTModel.load(MODEL)
    cfg0 = Config(data_path=os.path.join(ROOT, "data"))
    out = {"cards": mesh.size, "devices": [str(d) for d in mesh.devices], "smi": smi.splitlines()}

    def sync():
        for d in mesh.distinct:
            torch.cuda.synchronize(d)

    def timed(fn):
        sync()
        t = time.time()
        res = fn()
        sync()
        return res, time.time() - t

    kept = {}
    for label, n_titles in (("exact", 150_000), ("folded", 500_000)):
        cfg, truth, queries, actual = make_synthetic_world(n_titles, N_QUERIES, seed=SEED, config=cfg0)
        one, init_one = timed(lambda: Matcher(cfg, truth, model, device="cuda:0"))
        on_mesh, init_mesh = timed(lambda: Matcher(cfg, truth, model, mesh=mesh))
        one.predict(queries)
        on_mesh.predict(queries)
        secs = {"one": [], "mesh": []}
        for _ in range(reps):
            for who, m in (("one", one), ("mesh", on_mesh), ("mesh", on_mesh), ("one", one)):
                res, dt = timed(lambda: m.predict(queries))
                secs[who].append(dt)
                if who == "one":
                    r1 = res
                else:
                    r2 = res
        acc1, acc2 = (float((r.match_title_id == actual).mean()) for r in (r1, r2))
        v1, p1 = one.scorer.topk(queries)
        v2, p2 = on_mesh.scorer.topk(queries)
        same_topk = v1.tobytes() == v2.tobytes() and np.array_equal(p1, p2)
        same_pred = (np.array_equal(r1.match_title_id, r2.match_title_id)
                     and r1.prediction.tobytes() == r2.prediction.tobytes())
        out[label] = {"titles": n_titles, "init_one_s": init_one, "init_mesh_s": init_mesh,
                      "one_s": secs["one"], "mesh_s": secs["mesh"],
                      "one_q_per_s_median": N_QUERIES / float(np.median(secs["one"])),
                      "mesh_q_per_s_median": N_QUERIES / float(np.median(secs["mesh"])),
                      "accuracy_one": acc1, "accuracy_mesh": acc2, "topk_equal": same_topk,
                      "predictions_equal": same_pred,
                      "mesh_stage_seconds": r2.stage_seconds, "one_stage_seconds": r1.stage_seconds}
        print(f"# {label} {n_titles} titles x {N_QUERIES} queries on {mesh.size} card(s): one card "
              f"median {out[label]['one_q_per_s_median']:.1f} q/s, mesh "
              f"{out[label]['mesh_q_per_s_median']:.1f} q/s; accuracy {acc1:.4f} / {acc2:.4f}; "
              f"top-k equal {same_topk}, predictions equal {same_pred}", flush=True)
        if label == "exact" and not (same_topk and same_pred):
            raise AssertionError("the exact mesh differs from one card")
        if abs(acc1 - acc2) > 0.01:
            raise AssertionError(f"the folded mesh's accuracy {acc2:.4f} is off one card's {acc1:.4f}")
        if profile_dir:
            kept[label] = (one, on_mesh, queries)
        del one, on_mesh
        torch.cuda.empty_cache()

    sub, train = quick_train_rows(cfg, truth)
    params = GBTParams.from_config(cfg)
    params.num_boost_round = params.early_stopping_rounds = ROUNDS
    (m1, rep1), t1 = timed(lambda: train_model(cfg, train=train, truth=sub, params=params,
                                               save=False, device="cuda:0"))
    (m2, rep2), t2 = timed(lambda: train_model(cfg, train=train, truth=sub, params=params,
                                               save=False, mesh=mesh))
    equal = sum(all(getattr(m1, k)[i].tobytes() == getattr(m2, k)[i].tobytes() for k in TREE_FIELDS)
                for i in range(min(m1.num_trees, m2.num_trees)))
    out["train"] = {"one_s": t1, "mesh_s": t2, "one_timings": rep1["timings"],
                    "mesh_timings": rep2["timings"], "trees_equal": equal, "trees": m1.num_trees}
    print(f"# train {ROUNDS} rounds: one card {t1:.3f} s, mesh {t2:.3f} s; {equal} of {m1.num_trees} "
          f"trees equal bit for bit", flush=True)
    if equal != m1.num_trees or m1.num_trees != m2.num_trees:
        raise AssertionError("the mesh's training differs from one card's")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        out["profile"] = {}
        for label, (one, on_mesh, queries) in kept.items():
            for who, m, devs in (("one", one, [torch.device("cuda", 0)]),
                                 ("mesh", on_mesh, list(mesh.distinct))):
                p = profile_predict(torch, m, queries, devs,
                                    os.path.join(profile_dir, f"{label}_{who}.txt"))
                out["profile"][f"{label}_{who}"] = p
                calls = {k: v["count"] for k, v in p["host_calls"].items()}
                print(f"# profile {label} {who}: {p['wall_s']:.3f} s profiled; busy ms "
                      f"{json.dumps({k: round(v, 1) for k, v in p['device_busy_ms'].items()})}; "
                      f"host calls {json.dumps(calls)}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
