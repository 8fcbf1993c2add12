"""MSDA test cases shared by the port's CPU and card tests (numpy only, so
that the card tests run where jax is not installed): in bounds, mixed in and
out of bounds, fully outside, and u, v exactly at 0, 1 and at pixel centres
(the cases of tests/test_msda_torch_oracle.py)."""

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


CASES = {
    'in_bounds': lambda: _case(0, 0.05, 0.95),
    'mixed': lambda: _case(1, -0.3, 1.3),
    'outside': lambda: _case(2, 1.3, 2.0),
    'boundary': _boundary_case,
}
