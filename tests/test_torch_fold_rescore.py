"""PyTorch port: the folded engine's select and exact rescore after kernel A
(``ops/fold.py``: ``select_rescore`` and its plain version).

On CPU tensors the wrapper runs ``select_rescore_plain`` and launches
nothing; the plain version is held to a per-row numpy reference (float32
arithmetic, one term at a time, the zero-weight slots skipped as kernel G
skips them) and to tie rules written out by hand: equal window maxima go to
the lower window (-0.0 equal to +0.0), equal rescored values to the lower
coarse rank.  Kernel G itself, the CUDA route, is held bit for bit to the
plain version in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from doppelspeller_tpu_torch.config import TRIGRAM_VOCAB_SIZE as V
from doppelspeller_tpu_torch.ops import fold
from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
from doppelspeller_tpu_torch.ops.fold import select_rescore, select_rescore_plain


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, qb, nw, ntp, nt, lq, ltw):
    """Window maxima with runs of equal values, their titles (some past nt),
    a block's ids (V and weight 0 in the unused slots, one all-padding row)
    and trigram lists that hold some of the query ids."""
    rng = np.random.default_rng(seed)
    wmax = rng.choice(np.linspace(-1.0, 1.0, 17), (qb, nw)).astype(np.float32)
    warg = rng.integers(0, ntp, (qb, nw)).astype(np.int32)
    ids = rng.integers(0, 60, (qb, lq))
    n_real = rng.integers(0, lq + 1, qb)
    n_real[0] = 0
    ids[np.arange(lq)[None, :] >= n_real[:, None]] = V
    w_val = np.where(ids == V, 0.0, rng.random((qb, lq)) * 5 + 0.5).astype(np.float32)
    maxint = (w_val.sum(axis=1) * 1.25).astype(np.float32)
    tl = rng.integers(0, 60, (ntp, ltw))
    tl[rng.random((ntp, ltw)) < 0.5] = V
    tl[nt:] = V
    sums = (rng.random(ntp) * 20 + 1).astype(np.float32)
    sums[nt:] = 0.0
    t = [torch.from_numpy(x) for x in (wmax, warg, tl.astype(np.int32), sums)]
    return t + [torch.from_numpy(ids), torch.from_numpy(w_val),
                torch.from_numpy(maxint)]


def _reference(wmax, warg, tl, sums, ids, w_val, maxint, nt, kprime, k):
    """Row by row in numpy: stable orders, float32 sums one term at a time."""
    wmax, warg, tl, sums, ids, w_val, maxint = (x.numpy() for x in (wmax, warg, tl, sums, ids,
                                                                    w_val, maxint))
    out_v, out_p = [], []
    for q in range(wmax.shape[0]):
        cand = warg[q, np.argsort(-wmax[q], kind="stable")[:kprime]]
        jacc = np.empty(len(cand), np.float32)
        for r, pos in enumerate(cand):
            if not 0 <= pos < nt:
                jacc[r] = -1.0
                continue
            c = np.float32(0.0)
            for x, w in zip(ids[q], w_val[q]):
                if w != 0 and x in tl[pos]:
                    c = np.float32(c + w)
            denom = np.float32(np.float32(sums[pos] + maxint[q]) - c)
            jacc[r] = np.float32(c / max(denom, np.float32(1e-9)))
        order = np.argsort(-jacc, kind="stable")[:k]
        out_v.append(jacc[order])
        out_p.append(cand[order])
    return np.stack(out_v), np.stack(out_p)


@pytest.mark.parametrize("qb,nw,lq", [(5, 256, 16), (3, 128, 40)])
def test_cpu_wrapper_takes_the_plain_version_and_launches_nothing(qb, nw, lq):
    args = _inputs(qb + nw, qb, nw, ntp=512, nt=450, lq=lq, ltw=24)
    before = select_rescore.launches
    vals, pos = select_rescore(*args, 450, 32, 10)
    assert select_rescore.launches == before
    pv, pp = select_rescore_plain(*args, 450, 32, 10)
    assert torch.equal(vals, pv) and torch.equal(pos, pp)
    assert vals.dtype == torch.float32 and pos.dtype == torch.int32 and vals.shape == (qb, 10)
    rv, rp = _reference(*args, 450, 32, 10)
    assert np.array_equal(vals.numpy().view(np.int32), rv.view(np.int32))
    assert np.array_equal(pos.numpy(), rp)
    assert (vals[0] == torch.where(pos[0] < 450, 0.0, -1.0)).all()   # the all-padding row


def _hand_block(wmax, warg, tl_rows, ids, w_val, maxint, ntp=32, ltw=4):
    tl = torch.full((ntp, ltw), V, dtype=torch.int32)
    for title, row in tl_rows.items():
        tl[title, :len(row)] = torch.tensor(row, dtype=torch.int32)
    return (torch.tensor(wmax, dtype=torch.float32), torch.tensor(warg, dtype=torch.int32), tl,
            torch.full((ntp,), 3.0), torch.tensor(ids, dtype=torch.int64),
            torch.tensor(w_val, dtype=torch.float32), torch.tensor(maxint, dtype=torch.float32))


def test_plain_coarse_ties_go_to_the_lower_window():
    """No weight, so every rescored score is 0 and the final order is the
    coarse one: 0.9 (windows 1, 3), 0.5 (0, 2, 5), 0.1 (4), then -0.0 and
    +0.0, equal, in window order (6, 7)."""
    args = _hand_block([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5, -0.0, 0.0]],
                       [[10, 11, 12, 13, 14, 15, 16, 17]], {}, [[V, V]], [[0.0, 0.0]], [0.0])
    vals, pos = select_rescore(*args, 20, 8, 8)
    assert pos.tolist() == [[11, 13, 10, 12, 15, 14, 16, 17]]
    assert vals.tolist() == [[0.0] * 8]
    _, pos = select_rescore(*args, 20, 7, 7)             # k' cuts between the zeros
    assert pos.tolist() == [[11, 13, 10, 12, 15, 14, 16]]


def test_plain_rescored_ties_go_to_the_lower_coarse_rank():
    """Query ids 5 and 7 weigh 1 and 2 (maxint 3, every sum 3).  Row 0's
    coarse top 4 are the titles 11, 13, 10, 12, scoring 3/3, 2/4, 1/5, 2/4:
    the two 0.5 keep their coarse order (13 before 12).  Row 1 sends window
    1 past nt (title 25): it scores -1 and drops out of the top 3."""
    rows = {10: [5, 9], 11: [5, 7], 12: [7, 8], 13: [7]}
    args = _hand_block([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.2, 0.3]] * 2,
                       [[10, 11, 12, 13, 14, 15, 16, 17], [10, 25, 12, 13, 14, 15, 16, 17]],
                       rows, [[5, 7, V, V]] * 2, [[1.0, 2.0, 0.0, 0.0]] * 2, [3.0, 3.0])
    vals, pos = select_rescore(*args, 20, 4, 3)
    assert pos.tolist() == [[11, 13, 12], [13, 12, 10]]
    assert torch.equal(vals, torch.tensor([[1.0, 0.5, 0.5], [0.5, 0.5, 0.2]]))


def test_plain_output_width_follows_k_kprime_and_the_windows():
    """(QB, min(k, k', NW)), as the sort's slices give it."""
    args = _inputs(3, 2, 8, ntp=64, nt=60, lq=4, ltw=8)
    assert select_rescore(*args, 60, 16, 12)[0].shape == (2, 8)
    assert select_rescore(*args, 60, 4, 6)[1].shape == (2, 4)


def _bad_inputs():
    good = _inputs(4, 2, 16, ntp=64, nt=60, lq=4, ltw=8)
    wmax, warg, tl, sums, ids, w_val, maxint = good

    def swap(i, x):
        return tuple(x if j == i else t for j, t in enumerate(good))

    return [
        ("wmax f64", TypeError, swap(0, wmax.double())),
        ("warg i64", TypeError, swap(1, warg.long())),
        ("ids f32", TypeError, swap(4, ids.float())),
        ("ids i32", TypeError, swap(4, ids.int())),
        ("tl i64", TypeError, swap(2, tl.long())),
        ("warg shape", ValueError, swap(1, warg[:, :8])),
        ("sums shape", ValueError, swap(3, sums[:32])),
        ("w_val shape", ValueError, swap(5, w_val[:, :2])),
        ("maxint shape", ValueError, swap(6, maxint[:1])),
        ("mixed devices", ValueError, swap(3, sums.to("meta"))),
        ("meta device", RuntimeError, tuple(t.to("meta") for t in good)),
    ]


@pytest.mark.parametrize("name,exc,args", _bad_inputs(), ids=[c[0] for c in _bad_inputs()])
def test_wrapper_raises_on_what_it_does_not_take(name, exc, args):
    before = select_rescore.launches
    with pytest.raises(exc):
        select_rescore(*args, 60, 8, 4)
    assert select_rescore.launches == before


def test_launch_counters_list_kernel_g():
    """G's launches count in graph replays as every kernel's do."""
    assert (fold.select_rescore, "launches") in jk.launch_counters()
    before = select_rescore.launches
    _, launches = jk.uncounted(lambda: fold._build.count(select_rescore))
    assert select_rescore.launches == before
    jk.count_replay(launches)
    assert select_rescore.launches == before + 1
    select_rescore.launches = before
