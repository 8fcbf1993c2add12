"""Shapes and operands of the int8 convolution shared by the CPU tests
(tests/test_torch_port_quant.py), the card tests
(tests/test_torch_port_cuda.py) and chip_smoke.py: small and awkward shapes
(ci = 3 as in the stem, ci = 8 and 4-byte rows, a ragged and an odd co, a
ragged M, stride 2 on odd sizes, 1x1 with the float epilogue) and seeded
operands. Imports numpy and torch only."""

import numpy as np
import torch

QCONV_SHAPES = {
    'stem_ci3_s2': dict(n=2, h=10, w=14, ci=3, co=8, k=3, stride=2),
    'ci8_ragged_co': dict(n=1, h=7, w=9, ci=8, co=12, k=3, stride=1),
    'ci48_s1': dict(n=2, h=6, w=8, ci=48, co=16, k=3, stride=1),
    'concat_1x1': dict(n=3, h=5, w=7, ci=40, co=24, k=1, stride=1),
    'odd_s2': dict(n=1, h=9, w=11, ci=16, co=8, k=3, stride=2),
    'co_past_two_tiles_m_past_one': dict(n=1, h=13, w=11, ci=32, co=136, k=3,
                                         stride=1),
    'k_past_three_stages_1x1': dict(n=2, h=9, w=8, ci=224, co=72, k=1,
                                    stride=1),
    'odd_co': dict(n=1, h=6, w=5, ci=16, co=13, k=3, stride=1),
}


def qconv_operands(sh, seed):
    """x (n, h, w, ci) and w (k, k, ci, co) int8 over the full range, HWIO as
    the JAX package lays its weights, and a (co,) > 0 and b (co,) float32
    that put the epilogue's values across [0, 127]."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (sh['n'], sh['h'], sh['w'], sh['ci'])) \
        .astype(np.int8)
    w = rng.randint(-127, 128, (sh['k'], sh['k'], sh['ci'], sh['co'])) \
        .astype(np.int8)
    scale = 60.0 / (127.0 * 127.0 * np.sqrt(sh['k'] ** 2 * sh['ci']))
    a = (rng.uniform(0.5, 1.5, sh['co']) * scale).astype(np.float32)
    b = (rng.randn(sh['co']) * 20.0 + 30.0).astype(np.float32)
    return x, w, a, b


def port_operands(sh, seed, dev):
    """The same operands as torch tensors on `dev`, the weights (co, k, k, ci)
    as the kernel reads them."""
    x, w, a, b = qconv_operands(sh, seed)
    w = np.ascontiguousarray(w.transpose(3, 0, 1, 2))
    return [torch.from_numpy(t).to(dev) for t in (x, w, a, b)]
