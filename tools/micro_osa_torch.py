#!/usr/bin/env python3
"""The fused OSA block of the PyTorch port on one NVIDIA card, alone: its
numerics against the plain version, then a chain of blocks timed beside the
same chain through cuDNN (twin of tools/dev_micro_osa_pallas.py:main).

    python tools/micro_osa_torch.py [--stage 4] [--iters 20] [--cams 7] [--blocks 8]

Builds one seeded random OSA block of VoVNet-99's stage 3 or 4 (the port's
OSAModule with non-trivial BN statistics), packs it for the kernel, and
prints: the kernel's largest difference from osa_reference; then the device
time of `--blocks` chained calls of the kernel (cin == cout, so a block's
y_pad is the next block's x_pad; the kernel zeroes y's halo rows), of the
same blocks through BN-folded cuDNN convs and one matmul, and of the port's
unfused conv / BN / ReLU modules, each as the mean of `--iters` chains queued
behind a device-side sleep, with the card's name and power limit. Needs a
card; raises without one.
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from chip_smoke import (card_line, device_ms, folded_cudnn_osa,  # noqa: E402
                        nhwc_plane, unfused_module_osa)
from far3d_tpu_torch.models.vovnet import OSAModule  # noqa: E402
from far3d_tpu_torch.ops import _build, osa  # noqa: E402


def seeded_module(sh, seed, device):
    """One identity OSAModule with fan-in scaled weights and BN statistics
    away from (0, 1), drawn with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    mod = OSAModule(sh['cin'], sh['cm'], sh['cout'], osa.NUM_CONVS, name='OSA',
                    identity=True).eval()
    with torch.no_grad():
        for name, p in list(mod.named_parameters()) + list(mod.named_buffers()):
            if name.endswith('running_var'):
                v = rng.uniform(0.5, 1.5, p.shape)
            elif name.endswith('norm.weight'):
                v = rng.uniform(0.75, 1.25, p.shape)
            elif p.dim() == 4:
                v = rng.standard_normal(p.shape) / np.sqrt(p[0].numel())
            else:
                v = rng.standard_normal(p.shape) * 0.1
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return mod.to(device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--stage', type=int, default=4, choices=(3, 4))
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--cams', type=int, default=7)
    ap.add_argument('--blocks', type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError('micro_osa_torch needs an NVIDIA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    card = card_line()
    sh = osa.shapes_for_stage(args.stage)
    h, w, wp, cin, cm, cout = (sh[k] for k in ('h', 'w', 'wp', 'cin', 'cm',
                                               'cout'))
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((args.cams, cin, h, w)) * 0.5)
                         .astype(np.float32)).to(dev, torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    module = seeded_module(sh, 1, dev)
    weights = osa.pack_osa_weights(module)
    mask = osa.interior_mask(h, w, wp, device=dev)
    x_pad = nhwc_plane(x, wp)

    with torch.inference_mode():
        y_pad, tsum = osa.fused_osa(x_pad, mask, weights, sh)
        torch.cuda.synchronize()
        y_ref, tsum_ref = osa.osa_reference(x_pad, mask, weights, sh)
        scale = y_ref.float().abs().max().item()
        err = (y_pad.float() - y_ref.float()).abs().max().item() / scale
        mean_err = (y_pad.float() - y_ref.float()).abs().mean().item() / scale
        tsum_err = ((tsum - tsum_ref).abs().max()
                    / tsum_ref.abs().max()).item()
        print(f'numerics against osa_reference: max rel {err:.3e}, mean rel '
              f'{mean_err:.3e}, tsum rel {tsum_err:.3e}')

        def fused_chain():
            xp = x_pad
            for _ in range(args.blocks):
                xp, _ = osa.fused_osa(xp, mask, weights, sh)
            return xp

        library, unfused = folded_cudnn_osa(module), unfused_module_osa(module)

        def cudnn_chain():
            cur = x
            for _ in range(args.blocks):
                cur = library(cur)[0].permute(0, 3, 1, 2)    # NHWC -> NCHW view
            return cur

        def module_chain():
            cur = x
            for _ in range(args.blocks):
                cur = unfused(cur)
            return cur

        before = _build.launch_counts['osa_fused']
        t_fused = device_ms(fused_chain, args.iters)
        launched = _build.launch_counts['osa_fused'] - before
        t_cudnn = device_ms(cudnn_chain, args.iters)
        t_module = device_ms(module_chain, args.iters)
    flops = args.blocks * args.cams * h * w * 2 * (
        9 * cin * cm + 4 * 9 * cm * cm + (cin + 5 * cm) * cout)
    print(f'{args.blocks}-block chain, stage {args.stage}, {args.cams} '
          f'cameras | osa_fused: {t_fused:.3f} ms '
          f'({flops / t_fused / 1e9:.1f} TFLOP/s, {launched} launches in all) '
          f'| folded cuDNN chain: {t_cudnn:.3f} ms '
          f'({flops / t_cudnn / 1e9:.1f} TFLOP/s) | unfused conv/BN/ReLU '
          f'modules: {t_module:.3f} ms | cuDNN / fused {t_cudnn / t_fused:.2f}x '
          f'[{card}]')
    return 0


if __name__ == '__main__':
    sys.exit(main())
