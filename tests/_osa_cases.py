"""Shapes and operands of the fused OSA block shared by the card tests
(tests/test_torch_port_cuda.py) and chip_smoke.py: small and awkward shapes,
seeded asymmetric operands, and the kernel-against-plain-version check with
its tolerance. Imports torch and the port only."""

import numpy as np
import torch

from far3d_tpu_torch.ops import osa

OSA_SHAPES = {
    'n1_w_one_less_than_wp': dict(n=1, h=6, w=15, wp=16, cin=32, cm=16, cout=32),
    'n3_w_much_less_than_wp': dict(n=3, h=5, w=5, wp=16, cin=48, cm=32, cout=48),
    'cm160_ragged_channel_tile': dict(n=2, h=9, w=20, wp=24, cin=64, cm=160,
                                      cout=64),
    'cout512_rows_past_one_tile': dict(n=1, h=20, w=11, wp=12, cin=32, cm=16,
                                       cout=512),
    'halo_equals_wp': dict(n=2, h=3, w=100, wp=128, cin=32, cm=16, cout=32),
}


def osa_operands(sh, seed, dev, negative_stage=None):
    """Asymmetric seeded operands of one fused OSA block on `dev`."""
    rng = np.random.default_rng(seed)
    n, h, w, cin, cm, cout = (sh[k] for k in ('n', 'h', 'w', 'cin', 'cm',
                                              'cout'))

    def t(a, dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    weights = dict(
        w1=t(rng.standard_normal((9 * cin, cm)) / np.sqrt(9 * cin), bf16),
        w2345=t(rng.standard_normal((4 * 9 * cm, cm)) / np.sqrt(9 * cm), bf16),
        wcat=t(rng.standard_normal((cin + 5 * cm, cout))
               / np.sqrt(cin + 5 * cm), bf16),
        s5=t(rng.uniform(0.8, 1.2, (5, cm)), f32),
        b5=t(rng.standard_normal((5, cm)) * 0.1, f32),
        sc=t(rng.uniform(0.8, 1.2, (1, cout)), f32),
        bc=t(rng.standard_normal((1, cout)) * 0.1, f32))
    if negative_stage is not None:
        weights['b5'][negative_stage] = -100.0
    x = t(rng.standard_normal((n, h, w, cin)) * 0.5, bf16)
    return (osa.pad_plane(x, sh['wp']),
            osa.interior_mask(h, w, sh['wp'], device=dev), weights)


def assert_osa_close(got, want, sh):
    """The kernel against `osa_reference` on the same operands: both sum the
    same bf16 products in f32, in another order, and round once per stage,
    so y may sit one bf16 step (2^-8) of its largest entry apart per stage,
    six stages deep; tsum (f32) within 1e-3 of its largest entry. Halo rows
    and pad columns of y must be exactly zero."""
    (y, tsum), (y_ref, tsum_ref) = got, want
    assert y.dtype == torch.bfloat16 and tsum.dtype == torch.float32
    assert y.shape == y_ref.shape and tsum.shape == tsum_ref.shape
    scale = y_ref.float().abs().max().item()
    err = (y.float() - y_ref.float()).abs().max().item()
    assert err <= 6 * 2.0 ** -8 * scale, (err, scale)
    tscale = tsum_ref.abs().max().item()
    terr = (tsum - tsum_ref).abs().max().item()
    assert terr <= 1e-3 * tscale, (terr, tscale)
    r = sh['h'] * sh['wp']
    assert not y[:, :osa.HALO].any() and not y[:, osa.HALO + r:].any()
    plane = y[:, osa.HALO:osa.HALO + r].reshape(y.shape[0], sh['h'], sh['wp'],
                                                -1)
    assert not plane[:, :, sh['w']:].any()
    return err, terr
