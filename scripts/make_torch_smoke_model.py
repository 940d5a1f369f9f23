"""Train the 60-tree GBT model that the PyTorch port's smoke run loads.

Runs the JAX package on the CPU: the bench's synthetic world (500k titles,
16,384 queries, seed 7), then ``bench.quick_train_model`` with 60 rounds,
and saves the model in the JAX package's own ``model.npz`` format to
``doppelspeller_tpu_torch/assets/bench_model_r60.npz``.  The PyTorch port
reads that file with ``doppelspeller_tpu_torch.models.gbt.GBTModel.load``.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_model.py

The port trains the same model itself, on the card, from the same world and
the same draws (its trees differ where retrieval orders tied candidates
otherwise and where f32 sums round otherwise; ``chip_smoke.py`` prints how
many are equal and both models' accuracies on the same queries):

    python -c "
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world, quick_train_model
    cfg, truth, _, _ = make_synthetic_world(500_000, 16_384, seed=7)
    model, report = quick_train_model(cfg, truth, 60, 'cuda')
    model.save('model_r60_card.npz'); print(report['timings'])"

The committed file stays the JAX package's: the smoke compares against it.
"""

import hashlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "doppelspeller_tpu_torch", "assets", "bench_model_r60.npz")


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bench import make_synthetic_world, quick_train_model

    t0 = time.time()
    cfg, truth, _queries, _actual = make_synthetic_world(500_000, 16_384, seed=7)
    t1 = time.time()
    model = quick_train_model(cfg, truth, 60)
    t2 = time.time()
    model.save(OUT)
    with open(OUT, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    print(f"world {t1 - t0:.1f}s, train {t2 - t1:.1f}s, "
          f"{model.num_trees} trees (best_ntree_limit {model.best_ntree_limit})")
    print(f"{OUT} sha256 {digest}")


if __name__ == "__main__":
    main()
