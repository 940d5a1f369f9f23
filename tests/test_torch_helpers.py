"""Helpers shared by the PyTorch port's tests; no tests of their own.

Imports no JAX, so ``tests/test_torch_cuda.py`` can use them where only
PyTorch is installed.
"""

import dataclasses
import pathlib

import numpy as np
import torch

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.ops.jaccard_kernels import untied_slots
from doppelspeller_tpu_torch.parallel.workers import Workers

MODEL = pathlib.Path(__file__).resolve().parents[1] / "doppelspeller_tpu_torch" / "assets" / "bench_model_r60.npz"


def port_config(jcfg, **overrides) -> Config:
    """The port's Config with every field of a JAX Config."""
    return Config(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(Config)}).with_(**overrides)


def compare_predictions(rj, rp) -> None:
    """A JAX and a port ``PredictionResult``: equal stages and match ids,
    predictions to 1e-5, equal stage counts."""
    np.testing.assert_array_equal(rj.stage, rp.stage)
    np.testing.assert_array_equal(rj.match_title_id, rp.match_title_id)
    np.testing.assert_allclose(rj.prediction, rp.prediction, atol=1e-5)
    assert rj.stage_counts == {k: rp.stage_counts[k] for k in rj.stage_counts}


def untied(vals, eps: float = 1e-6) -> np.ndarray:
    """``untied_slots`` of a numpy top-k score array, as a numpy mask."""
    return untied_slots(torch.tensor(np.asarray(vals)), eps).numpy()


def union_inputs(seed, qb, U, V, ntp, nt, integer=False):
    """Packed rows u8 (V, ntp/8), a union of U ids ending in 5 padding ids
    (0, no weight), dense weights f32 (qb, U), sums f32 (ntp,) and maxint
    f32 (qb,).  With ``integer`` every score is an exact ratio of small
    integers (equal in any summation order), and titles repeat, so ties
    are exact."""
    rng = np.random.default_rng(seed)
    packed = np.packbits(rng.random((V, ntp // 8, 8)) < 0.1, axis=2, bitorder="little")[:, :, 0]
    union_ids = np.zeros(U, np.int32)
    union_ids[: U - 5] = rng.choice(V, U - 5, replace=False)
    w = rng.random((qb, U)).astype(np.float32) * 3.0
    w[rng.random((qb, U)) < 0.85] = 0.0
    w[:, U - 5:] = 0.0
    sums = (rng.random(ntp) * 40.0 + 5.0).astype(np.float32)
    maxint = (rng.random(qb) * 30.0 + 5.0).astype(np.float32)
    if integer:
        w = np.round(w)
        sums = np.round(sums)
        maxint = np.round(maxint)
        bits = np.unpackbits(packed, axis=1, bitorder="little")
        src = rng.integers(0, 24, ntp)                       # every title copies one of 24
        packed = np.packbits(bits[:, src], axis=1, bitorder="little")
        sums = sums[src]
    sums[nt:] = 0.0
    return packed, union_ids, w, sums, maxint


class EagerGraphs(Workers):
    """Workers whose "graphs" are the step run again on its static inputs:
    the graphed paths' padding, keys, replays and cuts on the CPU."""

    graphed = True

    def capture(self, i, key, fn, inputs):
        static = tuple(x.clone() for x in inputs)
        self.graphs[i, key] = (fn, static)
        self.captures.setdefault(key[0], [0] * self.mesh.size)[i] += 1
        return fn(*static)

    def replay(self, i, key, inputs):
        fn, static = self.graphs[i, key]
        for dst, x in zip(static, inputs):
            dst[: x.shape[0]].copy_(x)
        self.replays.setdefault(key[0], [0] * self.mesh.size)[i] += 1
        return fn(*static)
