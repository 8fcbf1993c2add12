"""The port's matching (far3d_tpu_torch/train/matching.py) against the JAX
package's ``far3d_tpu/train/matching.py`` on the CPU.

``auction_match`` is the JAX auction step for step, so the two agree
assignment for assignment (exactly) on the cases of tests/test_matching.py
(near-optimal, invalid columns, batched, the DETR-scale 1028 x 160 seeded
costs), on a tie-heavy matrix and on costs holding NaN and inf; the padded
problem batch of ``hungarian_match`` gives each problem its own answer; the
DETR-scale costs stay within the JAX test's gaps of scipy's optimum
(``lsa_host``, the oracle): a mean under 0.5% and each under 1.5% (two of
the uniform draws come to 0.72% and 0.80%, as JAX's auction's do, being the
same assignments; a training step's problems stay under 0.5% each,
``chip_smoke.py`` phase 20a). ``iou_xyxy_pair`` and ``hungarian_2d_cost`` are
held to JAX at the composed parity tolerance (rtol 1e-3 / atol 2e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from far3d_tpu.train import matching as jm
from far3d_tpu_torch.train import matching as tm


def both(cost, valid=None):
    """(JAX rows, port rows) of auction_match on the same cost."""
    want = np.asarray(jm.auction_match(
        jnp.asarray(cost), None if valid is None else jnp.asarray(valid)))
    got = tm.auction_match(torch.from_numpy(cost),
                           None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.int64
    return want, got.numpy()


@pytest.mark.parametrize('trial', range(5))
def test_auction_near_optimal_matches_jax(trial):
    """tests/test_matching.py:15-27's costs, drawn in its order."""
    rng = np.random.RandomState(0)
    for _ in range(trial + 1):
        cost = rng.rand(64, 13).astype(np.float32) * 10
    want, got = both(cost)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == 13


def test_auction_invalid_columns_match_jax():
    rng = np.random.RandomState(1)
    cost = rng.rand(32, 10).astype(np.float32)
    valid = np.zeros(10, bool)
    valid[:4] = True
    want, got = both(cost, valid)
    np.testing.assert_array_equal(got, want)
    assert (got[4:] == 0).all()


def test_batched_matches_jax_hungarian_match():
    rng = np.random.RandomState(2)
    cost = rng.rand(3, 20, 6).astype(np.float32)
    want = np.asarray(jm.hungarian_match(jnp.asarray(cost)))
    got = tm.auction_match(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(got, want)
    rows, = tm.hungarian_match([torch.from_numpy(cost)],
                               [torch.ones(3, 6, dtype=torch.bool)])
    np.testing.assert_array_equal(rows.numpy(), want)


def detr_costs():
    """tests/test_matching.py:38-58: 12 seeded (1028 x 160) costs, uniform
    and DETR-like (a few near queries per GT plus a class offset)."""
    r, c = 1028, 160
    rng = np.random.RandomState(7)
    costs = []
    for s in range(12):
        if s % 2 == 0:
            cost = rng.rand(r, c).astype(np.float32) * 10
        else:
            centers_q = rng.randn(r, 3).astype(np.float32) * 50
            centers_g = centers_q[rng.choice(r, c, replace=False)] + \
                rng.randn(c, 3).astype(np.float32) * 2
            cost = np.abs(centers_q[:, None] - centers_g[None]).sum(-1) * 0.25
            cost += rng.rand(r, 1).astype(np.float32) * 2.0
        costs.append(cost)
    return np.stack(costs)


def test_auction_detr_scale_matches_jax_and_scipy():
    costs = detr_costs()
    want = np.asarray(jm.hungarian_match(jnp.asarray(costs)))
    tm.reset_stats()
    got = tm.auction_match(torch.from_numpy(costs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tm.STATS['problems'] == 12 and tm.STATS['greedy'] == 0
    assert 0 < tm.STATS['iterations'] <= 500
    opt_rows = tm.lsa_host(costs)
    cols = np.arange(costs.shape[2])
    gaps = []
    for s in range(len(costs)):
        assert len(set(got[s].tolist())) == costs.shape[2]
        ours = costs[s][got[s], cols].sum()
        opt = costs[s][opt_rows[s], cols].sum()
        gaps.append((ours - opt) / max(abs(opt), 1e-6))
    gaps = np.asarray(gaps)
    assert gaps.min() >= -1e-5
    assert gaps.mean() < 0.005 and gaps.max() < 0.015, gaps


def test_auction_ties_match_jax():
    """Integer costs from {0, 1, 2}: every bid meets ties in the best row,
    the second-best value and the highest bid of a row, where both take the
    first maximal index."""
    rng = np.random.RandomState(3)
    for r, c in ((40, 12), (30, 30), (200, 50)):
        cost = rng.randint(0, 3, (r, c)).astype(np.float32)
        want, got = both(cost)
        np.testing.assert_array_equal(got, want)
    flat = np.zeros((16, 8), np.float32)
    want, got = both(flat)
    np.testing.assert_array_equal(got, want)


def test_auction_nonfinite_costs_match_jax():
    """A NaN makes the problem's eps NaN, so no bid wins and the greedy
    completion assigns every column (matching.py:121-132); inf rows and
    -inf columns make non-finite bids, which bid eps (matching.py:97)."""
    rng = np.random.RandomState(4)
    cost = rng.rand(20, 6).astype(np.float32)
    cost[3, 2] = np.nan
    cost[5] = np.inf
    tm.reset_stats()
    want, got = both(cost)
    np.testing.assert_array_equal(got, want)
    assert tm.STATS['greedy'] == 1
    cost = rng.rand(20, 6).astype(np.float32)
    cost[5] = np.inf
    cost[:, 1] = -np.inf
    want, got = both(cost)
    np.testing.assert_array_equal(got, want)


def test_padded_batch_equals_each_problem_alone():
    """One hungarian_match call over the shapes of a step: decoder-layer
    costs (B, Q, G) with invalid GT columns of cost BIG_COST, and a DN-like
    cost (B, groups, S, gmax) whose invalid slots cost BIG_COST and invalid
    columns BIG_COST * 2 (dn.py:82-86), against each problem solved alone
    by both packages."""
    rng = np.random.RandomState(5)
    b, q, g = 2, 50, 9
    layers = []
    gt_ok = np.arange(g)[None] < np.array([[7], [3]])
    for _ in range(3):
        c = rng.rand(b, q, g).astype(np.float32) * 5
        layers.append(np.where(gt_ok[:, None], c, tm.BIG_COST))
    groups, gmax = 3, 4
    dn_ok = np.arange(gmax)[None] < np.array([[4], [2]])
    slots = np.tile(dn_ok, (1, 3))                       # (B, S)
    dn = rng.rand(b, groups, 3 * gmax, gmax).astype(np.float32) * 20
    dn = np.where(slots[:, None, :, None], dn, tm.BIG_COST)
    dn = np.where(dn_ok[:, None, None, :], dn, tm.BIG_COST * 2)
    costs = layers + [dn]
    valid = [gt_ok] * 3 + [np.broadcast_to(dn_ok[:, None], (b, groups, gmax))]
    got = tm.hungarian_match([torch.from_numpy(c) for c in costs],
                             [torch.from_numpy(np.array(v)) for v in valid])
    for c, v, rows in zip(costs, valid, got):
        assert rows.shape == c.shape[:-2] + c.shape[-1:]
        alone = tm.auction_match(torch.from_numpy(c), torch.from_numpy(
            np.array(v)))
        np.testing.assert_array_equal(rows.numpy(), alone.numpy())
        want = np.asarray(jm.hungarian_match(jnp.asarray(c), jnp.asarray(v)))
        np.testing.assert_array_equal(rows.numpy(), want)


def test_iou_xyxy_pair_matches_jax():
    rng = np.random.RandomState(6)

    def boxes(n):
        xy = rng.uniform(0, 50, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(0, 30, (n, 2))],
                              -1).astype(np.float32)

    a, b = boxes(17), boxes(5)
    b[0] = b[1]                      # a duplicate and an empty box
    b[2, 2:] = b[2, :2]
    want = jm.iou_xyxy_pair(jnp.asarray(a), jnp.asarray(b))
    got = tm.iou_xyxy_pair(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=2e-3)


def test_hungarian_2d_cost_matches_jax():
    rng = np.random.RandomState(8)
    p, g, ncls, hw = 30, 6, 10, (64, 96)
    logits = rng.standard_normal((p, ncls)).astype(np.float32)
    ctr = rng.uniform(0, 60, (p, 2)).astype(np.float32)
    boxes = np.concatenate([ctr, rng.uniform(4, 30, (p, 2))],
                           -1).astype(np.float32)
    gxy = rng.uniform(0, 50, (g, 2))
    gt = np.concatenate([gxy, gxy + rng.uniform(4, 30, (g, 2))],
                        -1).astype(np.float32)
    labels = rng.randint(0, ncls, g)
    gctr = ((gt[:, :2] + gt[:, 2:]) / 2).astype(np.float32)
    args = (logits, boxes, ctr, gt, labels, gctr)
    want = np.asarray(jm.hungarian_2d_cost(*map(jnp.asarray, args), hw))
    got = tm.hungarian_2d_cost(*map(torch.from_numpy, args), hw)
    assert got.shape == (p, g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-3)
    # the cost feeds the auction as the JAX docstring says
    np.testing.assert_array_equal(
        tm.auction_match(got).numpy(),
        np.asarray(jm.auction_match(jnp.asarray(got.numpy()))))
