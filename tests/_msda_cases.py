"""MSDA test cases shared by the port's CPU and card tests (numpy only, so
that the card tests run where jax is not installed): in bounds, mixed in and
out of bounds, fully outside, and u, v exactly at 0, 1 and at pixel centres
(the cases of tests/test_msda_torch_oracle.py); crowded, where hundreds of
(query, point) pairs land on one of two pixels at every level, so a value
row gets hundreds of hits (the long runs of the value gradient's bucketed
reduction, longer than its 256-record chunks); production_like, the
model's C = 256, G = 8, P = 13 and 4 levels (52 (level, point) pairs, more
than a warp's lanes) at a query count that no block's query count
divides; rows_past_int16, 48,000 value rows a camera, more than the value
gradient's int16 keys hold; and sparse_pairs, the production operands'
sparsity at the model's C, G, P and level count: most (camera, query) pairs
have every point outside every level, the rest hit on every level, and some
points sit on exact pixel centres, so an in-bounds corner has a zero
bilinear weight but still a location gradient."""

import numpy as np

SHAPES = ((6, 8), (3, 4), (2, 2))


def _case(seed, lo, hi, shapes=SHAPES, b=2, q=5, p=4, g=2, c=8):
    rng = np.random.RandomState(seed)
    lt = sum(h * w for h, w in shapes)
    value = rng.randn(b, lt, c).astype(np.float32)
    loc = rng.uniform(lo, hi, size=(b, q, p, 2)).astype(np.float32)
    weights = rng.rand(b, q, g, len(shapes), p).astype(np.float32)
    return value, list(shapes), loc, weights


def _boundary_case():
    """u, v exactly at 0 and 1, and at exact pixel centres ((i + 0.5) / W)."""
    value, shapes, _, weights = _case(3, 0, 1, b=1, q=4, p=4)
    loc = np.array([[
        [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]],
        [[0.5, 0.5], [0.5 / 8, 0.5 / 6], [7.5 / 8, 5.5 / 6],
         [0.999999, 0.000001]],
        [[0.25, 0.75], [1.0, 0.5], [0.5, 1.0], [0.0, 0.5]],
        [[1e-7, 1e-7], [1 - 1e-7, 1 - 1e-7], [0.5, 0.0], [0.5, 1.0]],
    ]], np.float32)
    return value, shapes, loc, weights


def _crowded_case():
    """64 queries x 12 points a camera: three quarters of the pairs on one
    spot, the rest on another, each jittered by less than a pixel of the
    finest level, so the corner rows of a spot take hundreds of hits at
    every level (768 at most)."""
    value, shapes, _, weights = _case(5, 0, 1, b=2, q=64, p=12, g=2, c=16)
    rng = np.random.RandomState(6)
    spot = np.where(rng.rand(2, 64, 12, 1) < 0.75, [0.37, 0.58], [0.71, 0.22])
    loc = (spot + rng.uniform(-0.01, 0.01, size=(2, 64, 12, 2))).astype(
        np.float32)
    return value, shapes, loc, weights


def _sparse_pairs_case():
    """C = 256, G = 8, P = 13, four levels of power-of-two sizes, 2 cameras x
    41 queries: about 78% of the (camera, query) pairs (as at decoder layer 0
    of a full-width train step) have all 13 points in [1.3, 2.0], outside
    every level; the other pairs have their points in [0.05, 0.95], with a
    valid corner on every level. In each such pair, points 0-2 sit on exact
    pixel centres ((2k + 1) / 2W and (2m + 1) / 2H, exact in binary) of
    level 0, 1 and 2: x or y is an integer there, so dx or dy is exactly 0
    and two in-bounds corners have zero bilinear weight."""
    shapes = ((16, 32), (8, 16), (4, 8), (2, 4))
    value, shapes, _, weights = _case(10, 0, 1, shapes=shapes, b=2, q=41,
                                      p=13, g=8, c=256)
    rng = np.random.RandomState(11)
    hit = rng.rand(2, 41) < 0.22
    loc = np.where(hit[:, :, None, None],
                   rng.uniform(0.05, 0.95, size=(2, 41, 13, 2)),
                   rng.uniform(1.3, 2.0, size=(2, 41, 13, 2)))
    for p, (h, w) in enumerate(shapes[:3]):
        k = rng.randint(0, w, size=(2, 41))
        m = rng.randint(0, h, size=(2, 41))
        centre = np.stack([(2 * k + 1) / (2 * w), (2 * m + 1) / (2 * h)], -1)
        loc[:, :, p] = np.where(hit[:, :, None], centre, loc[:, :, p])
    return value, list(shapes), loc.astype(np.float32), weights


CASES = {
    'in_bounds': lambda: _case(0, 0.05, 0.95),
    'mixed': lambda: _case(1, -0.3, 1.3),
    'outside': lambda: _case(2, 1.3, 2.0),
    'boundary': _boundary_case,
    'crowded': _crowded_case,
    'production_like': lambda: _case(
        8, -0.2, 1.2, shapes=((16, 24), (8, 12), (4, 6), (2, 3)), b=2, q=37,
        p=13, g=8, c=256),
    'rows_past_int16': lambda: _case(
        9, -0.1, 1.1, shapes=((160, 240), (80, 120)), b=2, q=6, p=4),
    'sparse_pairs': _sparse_pairs_case,
}
