"""The plain reference's k-NN, the comparison that decides ``correct``,
and the MAP, recall and percentile arithmetic, on small inputs."""

import numpy as np
import pytest
import torch

from portbench.frozen import accuracy, randomwalk
from portbench.frozen.queries import NoisyQueries, collection_std
from portbench.reference.judge import checks, failed, judge, passed
from portbench.reference.knn import knn, round_tf32


def _data(n=3000, length=256, nq=40, seed=0):
    x = randomwalk.generate(n, length, torch.Generator().manual_seed(seed))
    src = NoisyQueries(x, [0.0, 0.01, 0.05, 0.1, 0.25],
                       torch.Generator().manual_seed(seed + 1),
                       collection_std(x))
    return x, src.next(nq)


def test_random_walks_are_z_normalized():
    x = randomwalk.generate(64, 256, torch.Generator().manual_seed(3))
    assert x.shape == (64, 256) and x.dtype == torch.float32
    assert torch.allclose(x.mean(1), torch.zeros(64), atol=1e-5)
    assert torch.allclose(x.std(1, unbiased=False), torch.ones(64),
                          atol=1e-4)
    again = randomwalk.generate(64, 256, torch.Generator().manual_seed(3))
    assert torch.equal(x, again)


def test_noisy_queries_cycle_their_levels_and_repeat_by_seed():
    x = randomwalk.generate(100, 32, torch.Generator().manual_seed(1))
    a = NoisyQueries(x, [0.0, 0.5], torch.Generator().manual_seed(2), 1.0)
    b = NoisyQueries(x, [0.0, 0.5], torch.Generator().manual_seed(2), 1.0)
    qa = torch.cat([a.next(3), a.next(3)])
    qb = torch.cat([b.next(3), b.next(3)])
    assert torch.equal(qa, qb)
    # level 0 lanes are rows of the collection
    d = torch.cdist(qa[0::2], x).amin(1)
    assert torch.all(d < 1e-4)
    assert collection_std(x) == pytest.approx(
        float(x.double().std(unbiased=False)), rel=1e-9)


def test_knn_matches_numpy_brute_force():
    x, q = _data()
    d, i = knn(x, q, 10, q_block=16)
    xd, qd = x.double().numpy(), q.double().numpy()
    full = ((qd[:, None, :] - xd[None, :, :]) ** 2).sum(-1)
    want = np.sort(full, 1)[:, :10]
    np.testing.assert_allclose(d.double().numpy(), want, atol=2e-3)
    got = np.take_along_axis(full, i.numpy(), 1)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest():
    v = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12,
                      -3.14159, 1e-20])
    r = round_tf32(v)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert r[0] == 1.0 and r[1] == 1.0          # tie to even
    assert r[2] == 1.0 + 2 ** -10
    assert torch.all((r - v).abs() <= v.abs() * 2 ** -11)


@pytest.mark.parametrize("config", ["search2m-coop", "search2m-solo"])
def test_judge_passes_the_f32_reference_and_fails_its_tf32_control(config):
    """The control at a size a test run holds: the reference put in the
    program's place with TF32 matmuls fails the configuration's limit,
    and the f32 reference passes it."""
    import json

    from portbench.bench.spec import ROOT

    limits = json.loads((ROOT / f"portbench/configs/{config}.json")
                        .read_text())["limits"]
    x, q = _data(n=4000, nq=200)
    d, i = knn(x, q, 100)
    ref = judge(x, q, i, d.clamp_min(0).sqrt(), i)
    assert passed(ref, limits) and failed(ref, limits) == 0
    assert ref["map_shortfall"] == 0.0
    d, i_con = knn(x, q, 100, tf32=True)
    con = judge(x, q, i_con, d.clamp_min(0).sqrt(), i)
    assert not passed(con, limits)
    assert con["sq_dist_gap"] > 3 * ref["sq_dist_gap"]
    assert list(checks(con, limits)) == ["bad_lanes", "sq_dist_gap",
                                         "map_shortfall"]


@pytest.mark.parametrize("fault", ["other_row", "no_answer", "unsorted",
                                   "twice"])
def test_judge_catches_an_altered_answer(fault):
    x, q = _data(nq=8)
    d, i = knn(x, q, 5)
    true = i
    d = d.clamp_min(0).sqrt()
    limits = {"bad_lanes": 0, "sq_dist_gap": 0.01, "map_shortfall": 0.5}
    assert passed(judge(x, q, i, d, true), limits)
    i, d = i.clone(), d.clone()
    if fault == "other_row":
        i[3, 1] = (i[3, 1] + 1) % x.shape[0]
    elif fault == "no_answer":
        i[3, 4], d[3, 4] = -1, float("inf")
    elif fault == "unsorted":
        d[3, [0, 4]] = d[3, [4, 0]]
        i[3, [0, 4]] = i[3, [4, 0]]
    else:
        i[3, 2], d[3, 2] = i[3, 1], d[3, 1]
    r = judge(x, q, i, d, true)
    assert not passed(r, limits) and failed(r, limits) == 1


def test_judge_catches_other_rows_with_true_distances():
    """An answer of rows further out than the k nearest, each with its
    own true distance: only the MAP's shortfall shows it, and the lanes
    that fall short count as failed."""
    x, q = _data(nq=8)
    d, i = knn(x, q, 10)
    true = i[:, :5]
    limits = {"bad_lanes": 0, "sq_dist_gap": 0.01, "map_shortfall": 0.05}
    r = judge(x, q, true, d[:, :5].clamp_min(0).sqrt(), true)
    assert passed(r, limits) and r["map_shortfall"] == 0.0
    # lanes 2 and 5 answer their 3rd-7th nearest, true distances kept
    got_i, got_d = true.clone(), d[:, :5].clone()
    got_i[[2, 5]], got_d[[2, 5]] = i[[2, 5], 2:7], d[[2, 5], 2:7]
    r = judge(x, q, got_i, got_d.clamp_min(0).sqrt(), true)
    assert r["bad_lanes"] == 0 and r["sq_dist_gap"] <= 0.01
    # AP of such a lane: (1/1 + 2/2 + 3/3) / 5 = 0.6
    assert r["map_shortfall"] == pytest.approx(2 * 0.4 / 8)
    assert not passed(r, limits) and failed(r, limits) == 2


def test_map_recall_and_the_percentile_by_hand():
    true = torch.tensor([[1, 2, 3, 4]])
    got = torch.tensor([[1, 9, 3, -1]])
    # rel = 1 0 1 0: AP = (1/1 + 2/3) / 4
    assert float(accuracy.average_precision(got, true)[0]) == \
        pytest.approx((1 + 2 / 3) / 4)
    assert float(accuracy.recall(got, true)[0]) == 0.5
    assert accuracy.percentile(list(range(1, 101)), 95) == 95
    assert accuracy.percentile([5.0, 1.0, 3.0], 50) == 3.0
    assert accuracy.percentile([7.0], 95) == 7.0
