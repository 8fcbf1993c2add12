"""Shapes and operands of the int8 convolution shared by the CPU tests
(tests/test_torch_port_quant.py), the card tests
(tests/test_torch_port_cuda.py) and chip_smoke.py: small and awkward shapes
(ci = 3 as in the stem, ci = 8 and 4-byte rows, a ragged and an odd co, a
ragged M, stride 2 on odd sizes, 1x1 with the float epilogue), shapes that
take the TMA kernel (ci = 160 and 224, whose K is not a multiple of 64
bytes; co = 224; an M ragged in both directions; a wide 1x1; stride 2),
channel slices of wider buffers in and out (both kernels), seeded
operands, and, for the card only, every class of StreamPETR's conv sites and
block tails at its 6 x 320 x 800 input. Imports numpy and torch only."""

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
    'tma_ci160': dict(n=1, h=9, w=13, ci=160, co=64, k=3, stride=1),
    'tma_ci224_co224': dict(n=1, h=6, w=10, ci=224, co=224, k=3, stride=1),
    'tma_ragged_m': dict(n=2, h=11, w=70, ci=64, co=128, k=3, stride=1),
    'tma_wide_1x1': dict(n=2, h=5, w=9, ci=288, co=256, k=1, stride=1),
    'tma_s2': dict(n=2, h=13, w=18, ci=64, co=32, k=3, stride=2),
}

# StreamPETR's VoVNet-99 at 6 cameras of 320 x 800: each class of conv site
# (the stem at 320x800 -> 160x400, stride 2 into stage 2's 80x200, the
# stages at 80x200, 40x100, 20x50 and 10x25, an odd width past the TMA box)
# with its real channels and epilogue (the concat convs f32); the camera
# count cut where the plane is large. Card only: the plain version is a
# float64 unfold, too slow at these sizes for the CPU suite.
PETR_QCONV_SHAPES = {
    'petr_stem1_ci3_s2': dict(n=1, h=320, w=800, ci=3, co=64, k=3, stride=2,
                              float_out=False),
    'petr_stem2': dict(n=1, h=160, w=400, ci=64, co=64, k=3, stride=1,
                       float_out=False),
    'petr_stem3_s2': dict(n=2, h=160, w=400, ci=64, co=128, k=3, stride=2,
                          float_out=False),
    'petr_s2_layer': dict(n=1, h=80, w=200, ci=128, co=128, k=3, stride=1,
                          float_out=False),
    'petr_s2_concat': dict(n=1, h=80, w=200, ci=768, co=256, k=1, stride=1,
                           float_out=True),
    'petr_s3_layer0': dict(n=2, h=40, w=100, ci=256, co=160, k=3, stride=1,
                           float_out=False),
    'petr_s3_layer': dict(n=2, h=40, w=100, ci=160, co=160, k=3, stride=1,
                          float_out=False),
    'petr_s3_concat': dict(n=2, h=40, w=100, ci=1312, co=512, k=1, stride=1,
                           float_out=True),
    'petr_s4_layer': dict(n=6, h=20, w=50, ci=192, co=192, k=3, stride=1,
                          float_out=False),
    'petr_s4_layer0': dict(n=6, h=20, w=50, ci=768, co=192, k=3, stride=1,
                           float_out=False),
    'petr_s4_concat': dict(n=6, h=20, w=50, ci=1728, co=768, k=1, stride=1,
                           float_out=True),
    'petr_s5_layer': dict(n=6, h=10, w=25, ci=224, co=224, k=3, stride=1,
                          float_out=False),
    'petr_s5_layer0': dict(n=6, h=10, w=25, ci=1024, co=224, k=3, stride=1,
                           float_out=False),
    'petr_s5_concat': dict(n=6, h=10, w=25, ci=2144, co=1024, k=1, stride=1,
                           float_out=True),
}

# Input and output as channel slices [off, off + c) of wider NHWC buffers
# (pixels `pitch` elements apart), as an OSA block's convs read and write its
# concat buffer: 16-byte aligned rows (the TMA kernel), and 8-byte aligned
# ones (the mma.sync kernel's 4-byte copies).
QCONV_SLICES = {
    'tma_slices': dict(n=2, h=7, w=12, ci=64, co=32, k=3, stride=1,
                       x_pitch=160, x_off=32, out_pitch=96, out_off=48),
    'tma_slices_1x1': dict(n=1, h=5, w=8, ci=96, co=64, k=1, stride=1,
                           x_pitch=224, x_off=128, out_pitch=192,
                           out_off=64),
    'mma_slices': dict(n=1, h=6, w=9, ci=24, co=8, k=3, stride=1,
                       x_pitch=40, x_off=8, out_pitch=24, out_off=16),
}
SENTINEL = 77          # what the output buffer holds outside the slice


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


def slice_operands(sh, seed, dev, float_out):
    """x as a slice of a seeded (n, h, w, x_pitch) int8 buffer, the weights
    and multipliers of ``port_operands``, and an (n, ho, wo, out_pitch)
    output buffer full of SENTINEL with its slice: (x, w, a, b, out_buf,
    out)."""
    x, w, a, b = port_operands(sh, seed, dev)
    rng = np.random.RandomState(seed + 1000)
    buf = torch.from_numpy(rng.randint(
        -127, 128, (sh['n'], sh['h'], sh['w'], sh['x_pitch'])).astype(
            np.int8)).to(dev)
    buf[..., sh['x_off']:sh['x_off'] + sh['ci']] = x
    ho = (sh['h'] + 2 * ((sh['k'] - 1) // 2) - sh['k']) // sh['stride'] + 1
    wo = (sh['w'] + 2 * ((sh['k'] - 1) // 2) - sh['k']) // sh['stride'] + 1
    out_buf = torch.full((sh['n'], ho, wo, sh['out_pitch']), SENTINEL,
                         dtype=torch.float32 if float_out else torch.int8,
                         device=dev)
    return (buf[..., sh['x_off']:sh['x_off'] + sh['ci']], w, a, b, out_buf,
            out_buf[..., sh['out_off']:sh['out_off'] + sh['co']])


# The OSA block tail (ops/quant.py:ese_requant): C channels, with or without
# the identity add, the identity read from and the output written to channel
# slices of wider buffers (pitch None: a contiguous tensor).
ESE_CASES = {
    'no_identity': dict(n=2, h=5, w=7, c=32, identity=False, xid_pitch=None,
                        out_pitch=None),
    'identity_slices': dict(n=2, h=6, w=9, c=48, identity=True, xid_pitch=80,
                            out_pitch=112),
    'wide_identity': dict(n=1, h=4, w=6, c=256, identity=True, xid_pitch=320,
                          out_pitch=None),
}

# StreamPETR's block tails: stage 2's first block (no identity, a new
# tensor), a stage-4 identity block writing slice 0 of the next block's
# concat buffer, stage 5's last block (10 x 25) reading its identity from its
# own concat buffer.
PETR_ESE_CASES = {
    'petr_stage2': dict(n=1, h=80, w=200, c=256, identity=False,
                        xid_pitch=None, out_pitch=None),
    'petr_stage4_identity': dict(n=6, h=20, w=50, c=768, identity=True,
                                 xid_pitch=1728, out_pitch=1744),
    'petr_stage5_identity': dict(n=6, h=10, w=25, c=1024, identity=True,
                                 xid_pitch=2144, out_pitch=None),
}


def ese_operands(case, seed, dev):
    """y (n, h, w, c) float32 >= 0 with zeros, gate (n, c) in [0, 1] with
    exact 0 and 1, r_out, and for an identity case x_id in [0, 127] (a slice
    at the start of its buffer) and s_id; out a slice of a SENTINEL-filled
    int8 buffer, or None. Values put (y * gate + x_id * s_id) * r_out across
    [0, 127] and past it. Returns (y, gate, r_out, x_id, s_id, out_buf,
    out)."""
    rng = np.random.RandomState(seed)
    n, h, w, c = case['n'], case['h'], case['w'], case['c']
    y = np.maximum(rng.randn(n, h, w, c) * 2.0, 0.0).astype(np.float32)
    gate = rng.uniform(0.0, 1.0, (n, c)).astype(np.float32)
    gate[:, :2] = [0.0, 1.0]
    t = lambda a: torch.from_numpy(a).to(dev)
    r_out = torch.tensor(37.3, dtype=torch.float32, device=dev)
    s_id = torch.tensor(0.021, dtype=torch.float32, device=dev)
    x_id = None
    if case['identity']:
        pitch = case['xid_pitch'] or c
        x_id = t(rng.randint(0, 128, (n, h, w, pitch)).astype(np.int8))
        x_id = x_id[..., :c]
    out_buf = out = None
    if case['out_pitch']:
        out_buf = torch.full((n, h, w, case['out_pitch']), SENTINEL,
                             dtype=torch.int8, device=dev)
        out = out_buf[..., 16:16 + c]
    return (t(y), t(gate), r_out, x_id, s_id if case['identity'] else None,
            out_buf, out)
