"""The fused VoVNet OSA block (counterpart of the library half of
``tools/dev_micro_osa_pallas.py``).

One call computes a whole OSA block per camera, up to its eSE gate: five
chained 3x3 convs, each with a folded-BN scale and bias, ReLU and the
pad-column mask, rounded to bf16; the 1x1 conv over the concat of the input
and the five intermediates, taken segment by segment so that no concat is
materialised; its scale, bias, ReLU and mask; and ``tsum``, the per-channel
sum of the f32 result over the plane, from which the caller forms the eSE
gate (the gate needs the whole plane's mean, so it cannot fuse).

Layout, as in the JAX tool: a plane (n, h, w, c) is widened to ``wp >= w + 1``
columns, flattened to rows = h * wp and given ``HALO`` zero rows above and
below: (n, h * wp + 2 * HALO, c), channels last. A 3x3 tap (dy, dx) is then
the same rows shifted by ``dy * wp + dx``, and the zero halo rows and zero
pad columns stand for the conv's zero padding. That needs ``HALO >= wp``: a
tap reaches wp + 1 rows up and down, and the one row this leaves outside the
plane when ``HALO == wp`` (stage 3) is a corner of the padding, read as zeros.

``fused_osa`` sends a CPU tensor to the plain version ``osa_reference`` and a
CUDA tensor to the hand-written kernel (``ops/osa_cuda.py``,
``csrc/osa_fused.cu``), which launches or raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

HALO = 128
OFFS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
NUM_CONVS = 5      # the kernel fixes five 3x3 convs (VoVNet-99's layers_per_block)


def shapes_for_stage(stage: int) -> Dict[str, int]:
    """The identity blocks of VoVNet-99 at a 640x960 image."""
    if stage == 4:
        # stage 4 blocks 2..9: in 768, conv 192, out 768, plane 40x60
        return dict(h=40, w=60, wp=64, cin=768, cm=192, cout=768)
    if stage == 3:
        # stage 3 blocks 2..3: in 512, conv 160, out 512, plane 80x120
        return dict(h=80, w=120, wp=128, cin=512, cm=160, cout=512)
    raise ValueError(stage)


def pad_plane(x: torch.Tensor, wp: int) -> torch.Tensor:
    """(n, h, w, c) -> (n, h*wp + 2*HALO, c) halo-padded row layout."""
    n, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, wp - w)).reshape(n, h * wp, c)
    return F.pad(x, (0, 0, HALO, HALO))


def unpad_plane(y: torch.Tensor, h: int, w: int, wp: int) -> torch.Tensor:
    """(n, h*wp + 2*HALO, c) -> (n, h, w, c)."""
    n = y.shape[0]
    return y[:, HALO:HALO + h * wp].reshape(n, h, wp, -1)[:, :, :w]


def interior_mask(h: int, w: int, wp: int, device=None) -> torch.Tensor:
    """(h*wp, 1) bf16: 1 on a row's w real columns, 0 on its pad columns."""
    col = torch.arange(h * wp, device=device) % wp < w
    return col.to(torch.bfloat16)[:, None]


def osa_reference(x_pad: torch.Tensor, mask: torch.Tensor,
                  weights: Dict[str, torch.Tensor],
                  sh: Dict[str, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same arguments and returns as
    ``fused_osa``. It repeats the kernel's arithmetic: f32 sums of bf16
    products, scale and bias in f32, ReLU, mask, one rounding to bf16 per
    stage, ``tsum`` from the f32 values, zero halo rows in ``y_pad``."""
    h, wp, cin, cm, cout = sh['h'], sh['wp'], sh['cin'], sh['cm'], sh['cout']
    n, rp, _ = x_pad.shape
    r = h * wp
    maskf = mask.float()

    def epilogue(acc, scale, bias, width):
        t = torch.relu(acc * scale + bias) * maskf
        out = x_pad.new_zeros((n, rp, width))
        out[:, HALO:HALO + r] = t.to(torch.bfloat16)
        return out, t

    def conv(src, w, c_in, stage):
        # one more zero row at each end: with a halo of exactly wp rows the
        # corner taps start one row outside the plane
        src = F.pad(src, (0, 0, 1, 1))
        acc = torch.zeros((n, r, cm), dtype=torch.float32, device=src.device)
        for k, (dy, dx) in enumerate(OFFS):
            off = 1 + HALO + dy * wp + dx
            acc += src[:, off:off + r].float() @ w[k * c_in:(k + 1) * c_in].float()
        return epilogue(acc, weights['s5'][stage], weights['b5'][stage], cm)[0]

    cs = [conv(x_pad, weights['w1'], cin, 0)]
    for i in range(1, NUM_CONVS):
        w = weights['w2345'][(i - 1) * 9 * cm:i * 9 * cm]
        cs.append(conv(cs[-1], w, cm, i))

    wcat = weights['wcat']
    acc = x_pad[:, HALO:HALO + r].float() @ wcat[:cin].float()
    for i, c in enumerate(cs):
        acc += c[:, HALO:HALO + r].float() \
            @ wcat[cin + i * cm:cin + (i + 1) * cm].float()
    y_pad, t = epilogue(acc, weights['sc'][0], weights['bc'][0], cout)
    return y_pad, t.sum(dim=1, keepdim=True)


def fused_osa(x_pad: torch.Tensor, mask: torch.Tensor,
              weights: Dict[str, torch.Tensor],
              sh: Dict[str, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_pad (n, rp, cin) bf16 -> (y_pad (n, rp, cout) bf16 before the gate,
    tsum (n, 1, cout) f32). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if x_pad.device.type == 'cpu':
        return osa_reference(x_pad, mask, weights, sh)
    from .osa_cuda import osa_fused
    return osa_fused(x_pad, mask, weights, sh)


def pack_osa_weights(osa_module) -> Dict[str, torch.Tensor]:
    """One ``models.vovnet.OSAModule`` (convs in OIHW, f32) -> the kernel's
    weights: ``w1`` (9*cin, cm) and ``w2345`` (4*9*cm, cm) tap-major then
    input channel, as an HWIO reshape gives them, ``wcat`` (cin + 5*cm, cout),
    all bf16 as the module casts them at its call; the frozen BN folded in
    f32 as ``FrozenBatchNorm.forward`` does, into ``s5``, ``b5`` (5, cm) and
    ``sc``, ``bc`` (1, cout)."""
    if len(osa_module.layers) != NUM_CONVS:
        raise ValueError(f'the fused block has {NUM_CONVS} 3x3 convs, the '
                         f'module has {len(osa_module.layers)}')

    def parts(block):
        conv, bn = block[0], block[1]
        inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        return conv.weight, inv, bn.bias - bn.running_mean * inv

    def hwio_rows(w):                       # (O, I, kh, kw) -> (kh*kw*I, O)
        return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]) \
            .to(torch.bfloat16).contiguous()

    with torch.no_grad():
        convs = [parts(layer) for layer in osa_module.layers]
        wc, sc, bc = parts(osa_module.concat)
        return dict(
            w1=hwio_rows(convs[0][0]),
            w2345=torch.cat([hwio_rows(w) for w, _, _ in convs[1:]]),
            wcat=hwio_rows(wc),
            s5=torch.stack([s for _, s, _ in convs]).float().contiguous(),
            b5=torch.stack([b for _, _, b in convs]).float().contiguous(),
            sc=sc.float()[None].contiguous(),
            bc=bc.float()[None].contiguous())


def osa_block(osa_module, x_pad: torch.Tensor, mask: torch.Tensor,
              packed: Dict[str, torch.Tensor],
              sh: Dict[str, int]) -> torch.Tensor:
    """A whole OSA block on the padded layout: the fused kernel, the eSE gate
    from ``tsum`` (mean over the h*w real pixels, ``fc``, hard sigmoid), and
    the identity add where the module has one. Returns the next block's
    ``x_pad``: the gate and the add keep zero rows and columns zero."""
    y_pad, tsum = fused_osa(x_pad, mask, packed, sh)
    n, _, cout = y_pad.shape
    mean = (tsum / (sh['h'] * sh['w'])).to(y_pad.dtype)
    s = osa_module.ese.fc(mean.reshape(n, cout, 1, 1)).reshape(n, 1, cout)
    out = y_pad * ((s + 3.0).clamp(0.0, 6.0) / 6.0)
    return out + x_pad if osa_module.identity else out
