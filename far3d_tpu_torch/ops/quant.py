"""Post-training int8 quantization of the VoVNet backbone, the serving mode
(counterpart of ``far3d_tpu/ops/quant.py``).

Three pieces, as in the JAX package:

1. ``calibrate_vovnet``: per-site activation amax from a few batches, taken
   by forward hooks on the bf16 model.
2. ``build_quant_vovnet``: folds the frozen BN into the conv weights, folds
   each conv's per-input-channel activation scales into the weight before a
   per-output-channel symmetric int8 quantization (so the concat of an OSA
   block needs no runtime rescale), and bakes the requantization
   multipliers. Done in float64 numpy, step for step as the JAX package
   does, so the same amax gives bitwise the same tree.
3. ``quant_vovnet_forward``: int8 convs with the scale, ReLU and requantize
   epilogue fused in (``ops/qconv.py``, the ``csrc/qconv.cu`` kernel on the
   card), eSE and the identity add in float32 (``ese_requant``, the
   ``csrc/ese_requant.cu`` kernel on the card), int8 activations NHWC from
   the stem to the stage outputs, which are dequantized to bf16. An OSA
   block's concat is one int8 buffer that its convs read and write in
   place: its input in slice 0 (where the block before it in the stage, or
   the stem's last conv, wrote it), layer ``li`` reading slice ``li`` and
   writing slice ``li + 1``, the concat conv reading it whole.

Activations are per tensor (post-ReLU, so [0, 127]; the signed stem input
[-127, 127]), weights per output channel.

Sites and the tree keep the JAX package's names: ``stem1``..``stem3``,
``stage{s}_block{b}`` for an OSA block's output and
``stage{s}_block{b}/layer{i}`` / ``/concat`` for its convs, with ``b``
counted from 0 (the port's module ``stage3.OSA3_2`` is ``stage3_block1``).
A leaf of the tree is a torch tensor on the backbone's device: ``w`` has the
JAX package's HWIO shape (k, k, ci, co) but lies in memory as the kernel
reads it, (co, k, k, ci), so ``w.permute(3, 0, 1, 2)`` is contiguous; the
per-channel ``a``, ``b``, ``ese_b`` and the (ci, co) ``ese_w`` are float32,
and the scalars (``s0``, ``s_id``, ``r_out``, ``stage{s}_scale``) 0-d
float32 tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import BackboneConfig
from ..models.vovnet import VoVNet
from .qconv import out_size, qconv

POOL_FILL = -128          # the int8 max pool's padding value


def vovnet_sites(backbone: VoVNet) -> Dict[str, nn.Module]:
    """{JAX site name: the port module whose output is that site}: the stem's
    ReLUs (the port's stem is one flat chain), each OSA block's conv blocks
    and the block itself."""
    cfg = backbone.cfg
    sites = {f'stem{i}': getattr(backbone.stem, f'stem_{i}/relu')
             for i in (1, 2, 3)}
    for si in range(4):
        stage = si + 2
        for bi in range(cfg.blocks_per_stage[si]):
            block = getattr(backbone, f'stage{stage}')[bi]
            name = f'stage{stage}_block{bi}'
            for li, layer in enumerate(block.layers):
                sites[f'{name}/layer{li}'] = layer
            sites[f'{name}/concat'] = block.concat
            sites[name] = block
    return sites


@torch.inference_mode()
def calibrate_vovnet(backbone: VoVNet,
                     batches: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Run the bf16 backbone on calibration batches (each (BN, 3, H, W) as
    ``VoVNet.forward`` takes it, normalized, bf16) and return {site: amax},
    the largest |x| of each site's output in float32 over all batches."""
    found: Dict[str, torch.Tensor] = {}

    def hook(name):
        def keep(module, args, out):
            m = out.float().abs().max()
            found[name] = m if name not in found else torch.maximum(
                found[name], m)
        return keep

    handles = [m.register_forward_hook(hook(name))
               for name, m in vovnet_sites(backbone).items()]
    try:
        for x in batches:
            backbone(x)
    finally:
        for h in handles:
            h.remove()
    return {name: float(m) for name, m in found.items()}


def input_scale_from_norm(img_mean: Sequence[float],
                          img_std: Sequence[float]) -> float:
    """Analytic amax of the normalized uint8 image over 127: the stem input
    needs no calibration, its range is exactly ((0|255) - mean) / std."""
    m, s = np.asarray(img_mean), np.asarray(img_std)
    return float(np.max(np.maximum(np.abs(-m / s), np.abs((255 - m) / s)))
                 / 127.0)


def _fold_bn(conv: nn.Conv2d, bn: nn.Module):
    """A conv weight with its frozen BN folded in, HWIO, and the folded
    bias, both float64."""
    w = conv.weight.detach().double().cpu().numpy().transpose(2, 3, 1, 0)
    inv = bn.weight.detach().double().cpu().numpy() / np.sqrt(
        bn.running_var.detach().double().cpu().numpy() + bn.eps)
    return w * inv, bn.bias.detach().double().cpu().numpy() - \
        bn.running_mean.detach().double().cpu().numpy() * inv


def _quantize_conv(w_f, b_f, s_in: np.ndarray, s_out, device) -> Dict:
    """s_in: per-input-channel activation scales, folded into the weight
    before symmetric per-output-channel quantization. s_out None => float
    output (a = s_w, b = b_f); else the multipliers are divided by s_out so
    that the runtime is ``clip(round(relu(acc * a + b)), 0, 127)``."""
    w_s = w_f * s_in[None, None, :, None]
    s_w = np.maximum(np.max(np.abs(w_s), axis=(0, 1, 2)), 1e-12) / 127.0
    w_q = np.clip(np.round(w_s / s_w), -127, 127).astype(np.int8)
    div = 1.0 if s_out is None else s_out
    w_kernel = torch.from_numpy(np.ascontiguousarray(
        w_q.transpose(3, 0, 1, 2))).to(device)            # (co, k, k, ci)
    return dict(w=w_kernel.permute(1, 2, 3, 0),             # HWIO view
                a=torch.from_numpy((s_w / div).astype(np.float32)).to(device),
                b=torch.from_numpy((b_f / div).astype(np.float32)).to(device))


def _scalar(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def build_quant_vovnet(backbone: VoVNet, amax: Dict[str, float],
                       img_mean: Sequence[float],
                       img_std: Sequence[float]) -> Dict:
    """The quantized parameter tree of `backbone` (see the module docstring),
    on the backbone's device."""
    cfg = backbone.cfg
    device = next(backbone.parameters()).device

    def fold(conv_bn, s_in, s_out):
        w_f, b_f = _fold_bn(*conv_bn)
        return _quantize_conv(w_f, b_f, np.asarray(s_in, np.float64), s_out,
                              device)

    def scale(site: str) -> float:
        return amax[site] / 127.0

    s0 = input_scale_from_norm(img_mean, img_std)
    stem = backbone.stem
    q: Dict = {'s0': _scalar(s0, device)}
    stem_block = {i: (getattr(stem, f'stem_{i}/conv'),
                      getattr(stem, f'stem_{i}/norm')) for i in (1, 2, 3)}
    q['stem1'] = fold(stem_block[1], np.full(3, s0), scale('stem1'))
    q['stem2'] = fold(stem_block[2], np.full(cfg.stem_channels[0],
                                             scale('stem1')), scale('stem2'))
    q['stem3'] = fold(stem_block[3], np.full(cfg.stem_channels[1],
                                             scale('stem2')), scale('stem3'))

    s_block_in = scale('stem3')
    c_block_in = cfg.stem_channels[2]
    for si in range(4):
        stage = si + 2
        for bi in range(cfg.blocks_per_stage[si]):
            name = f'stage{stage}_block{bi}'
            module = getattr(backbone, f'stage{stage}')[bi]
            sc, cc = cfg.stage_conv_channels[si], cfg.stage_out_channels[si]
            blk: Dict = {}
            s_cur, c_cur = s_block_in, c_block_in
            cat_scales = [np.full(c_block_in, s_block_in)]
            for li, layer in enumerate(module.layers):
                site = f'{name}/layer{li}'
                blk[f'layer{li}'] = fold((layer[0], layer[1]),
                                         np.full(c_cur, s_cur), scale(site))
                s_cur, c_cur = scale(site), sc
                cat_scales.append(np.full(sc, s_cur))
            blk['concat'] = fold((module.concat[0], module.concat[1]),
                                 np.concatenate(cat_scales), None)
            fc = module.ese.fc
            blk['ese_w'] = fc.weight.detach()[:, :, 0, 0].t().contiguous()
            blk['ese_b'] = fc.bias.detach().clone()
            blk['s_id'] = _scalar(s_block_in, device)    # identity-add scale
            s_out = scale(name)
            blk['r_out'] = _scalar(1.0 / s_out, device)
            q[name] = blk
            s_block_in, c_block_in = s_out, cc
        q[f'stage{stage}_scale'] = _scalar(s_block_in, device)
    return q


@torch.inference_mode()
def _quantize_backbone(backbone: VoVNet, img_mean: Sequence[float],
                       img_std: Sequence[float],
                       calib_images: Sequence[torch.Tensor]) -> Dict:
    """Calibrate `backbone` on image batches (uint8 or normalized float,
    (B, N, H, W, 3)) and build its quantized tree."""
    device = next(backbone.parameters()).device
    mean = torch.tensor(img_mean, device=device)
    std = torch.tensor(img_std, device=device)
    batches = []
    for img in calib_images:
        img = torch.as_tensor(img).to(device)
        if not img.is_floating_point():
            img = (img.float() - mean) / std
        batches.append(img.reshape(-1, *img.shape[-3:]).to(torch.bfloat16)
                       .permute(0, 3, 1, 2))
    amax = calibrate_vovnet(backbone, batches)
    return build_quant_vovnet(backbone, amax, img_mean, img_std)


def quantize_detector_backbone(model, calib_images: Sequence[torch.Tensor]
                               ) -> Dict:
    """One-call serving API: a ``Far3D`` and a few image batches (uint8 or
    normalized float, (B, N, H, W, 3)) -> the quantized backbone tree, to
    pass as ``Far3D.forward(..., quant_backbone=tree)`` or
    ``eval.runner.run_inference(..., quant_tree=tree)``."""
    return _quantize_backbone(model.img_backbone, model.cfg.data.img_mean,
                              model.cfg.data.img_std, calib_images)


def quantize_petr_backbone(model, calib_images: Sequence[torch.Tensor]
                           ) -> Dict:
    """The StreamPETR twin of ``quantize_detector_backbone`` (quant.py:
    209-225): the same calibration, folded with the module-level
    ``IMG_MEAN`` / ``IMG_STD`` that the model applies to uint8 images. Pass
    the tree as ``StreamPETR.forward(..., quant_backbone=tree)`` or
    ``eval.petr_runner.run_inference_petr(..., quant_tree=tree)``."""
    from ..config import IMG_MEAN, IMG_STD
    return _quantize_backbone(model.img_backbone, IMG_MEAN, IMG_STD,
                              calib_images)


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

def _qconv(qc: Dict, x_q: torch.Tensor, stride: int = 1,
           float_out: bool = False, out: Optional[torch.Tensor] = None,
           channel_sums: bool = False):
    return qconv(x_q, qc['w'].permute(3, 0, 1, 2).contiguous(), qc['a'],
                 qc['b'], stride, float_out, out, channel_sums)


def _concat_buffer(blk: Dict, n: int, h: int, w: int,
                   device) -> torch.Tensor:
    """A block's concat buffer: (n, h, w, C_in + layers * conv channels)
    int8, uninitialised."""
    return torch.empty((n, h, w, blk['concat']['w'].shape[2]), device=device,
                       dtype=torch.int8)


def ese_gate(blk: Dict, sums: torch.Tensor, hw: int) -> torch.Tensor:
    """The eSE gate (n, C) from the concat conv's channel sums over h*w
    pixels: hsig(mean @ ese_w + ese_b), hsig(g) = clip(g + 3, 0, 6) / 6."""
    g = (sums / hw) @ blk['ese_w'] + blk['ese_b']
    return (g + 3.0).clamp(0.0, 6.0) / 6.0


def ese_requant_reference(y: torch.Tensor, gate: torch.Tensor,
                          r_out: torch.Tensor,
                          x_id: Optional[torch.Tensor] = None,
                          s_id: Optional[torch.Tensor] = None,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the block tail: ``clip(round((y * gate [+ x_id *
    s_id]) * r_out), 0, 127)`` as int8, each product and sum rounded in
    float32, round half to even; into `out` when given."""
    v = y * gate[:, None, None, :]
    if x_id is not None:
        v.add_(x_id * s_id)
    q = v.mul_(r_out).round_().clamp_(0, 127).to(torch.int8)
    return q if out is None else out.copy_(q)


def ese_requant(y: torch.Tensor, gate: torch.Tensor, r_out: torch.Tensor,
                x_id: Optional[torch.Tensor] = None,
                s_id: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block tail: the plain version for a CPU tensor, the CUDA kernel
    (``ops/ese_requant_cuda.py``) for a CUDA one."""
    if y.is_cuda:
        from .ese_requant_cuda import ese_requant_cuda
        return ese_requant_cuda(y, gate, r_out, x_id, s_id, out)
    return ese_requant_reference(y, gate, r_out, x_id, s_id, out)


def _qosa(blk: Dict, x_q: torch.Tensor, layers: int, identity: bool,
          out: Optional[torch.Tensor] = None,
          buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One int8 OSA block. `buf` is its concat buffer with x_q in slice 0
    already (a new one, x_q copied in, when None); the output goes into
    `out` when given (slice 0 of the next block's buffer), else into a new
    tensor."""
    n, h, w, cin = x_q.shape
    if buf is None:
        buf = _concat_buffer(blk, n, h, w, x_q.device)
        buf[..., :cin].copy_(x_q)
    x_q = buf[..., :cin]
    sc = blk['layer0']['w'].shape[3]
    src = x_q
    for li in range(layers):
        dst = buf[..., cin + li * sc:cin + (li + 1) * sc]
        _qconv(blk[f'layer{li}'], src, out=dst)
        src = dst
    y, sums = _qconv(blk['concat'], buf, float_out=True, channel_sums=True)
    gate = ese_gate(blk, sums, h * w)
    if identity:
        return ese_requant(y, gate, blk['r_out'], x_q, blk['s_id'], out)
    return ese_requant(y, gate, blk['r_out'], out=out)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool with SAME padding on NHWC int8, the padding
    filled with -128 (``lax.reduce_window(..., 'SAME')``: at an even size
    nothing before and one after)."""
    n, h, w, c = x.shape
    ho, wo = -(-h // 2), -(-w // 2)
    ph, pw = max(2 * (ho - 1) + 3 - h, 0), max(2 * (wo - 1) + 3 - w, 0)
    xp = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
               value=POOL_FILL)
    taps = [xp[:, dy:dy + 2 * ho - 1:2, dx:dx + 2 * wo - 1:2]
            for dy in range(3) for dx in range(3)]
    out = torch.maximum(taps[0], taps[1])
    for tap in taps[2:]:
        out = torch.maximum(out, tap)
    return out


def quantize_input(x: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """Normalized image (float) -> signed int8: divided by s0, as the JAX
    package divides (not times its reciprocal)."""
    return torch.round(x.float() / s0).clamp_(-127, 127).to(torch.int8)


def quant_vovnet_forward(cfg: BackboneConfig, q: Dict,
                         x_q: torch.Tensor) -> List[torch.Tensor]:
    """int8 twin of ``VoVNet.forward``: x_q (BN, H, W, 3) int8 NHWC; returns
    the configured stage outputs dequantized to bf16, each (BN, C, Hl, Wl) in
    shape as ``VoVNet.forward`` returns them (channels last in memory)."""
    x = _qconv(q['stem1'], x_q, stride=2)
    x = _qconv(q['stem2'], x)
    outputs = []
    for si in range(4):
        stage = si + 2
        names = [f'stage{stage}_block{bi}'
                 for bi in range(cfg.blocks_per_stage[si])]
        n = x.shape[0]
        if stage == 2:                # stem3 writes into the first buffer
            k, cin = q['stem3']['w'].shape[0], q['stem3']['w'].shape[3]
            h, w = out_size(x.shape[1], k, 2), out_size(x.shape[2], k, 2)
            buf = _concat_buffer(q[names[0]], n, h, w, x.device)
            _qconv(q['stem3'], x, stride=2, out=buf[..., :cin])
        else:
            x = max_pool_same(x)
            h, w, cin = x.shape[1:]
            buf = _concat_buffer(q[names[0]], n, h, w, x.device)
            buf[..., :cin].copy_(x)
        for bi, name in enumerate(names):
            nxt = (_concat_buffer(q[names[bi + 1]], n, h, w, x.device)
                   if bi + 1 < len(names) else None)
            cout = q[name]['concat']['w'].shape[3]
            x = _qosa(q[name], buf[..., :cin], cfg.layers_per_block,
                      identity=(bi > 0),
                      out=None if nxt is None else nxt[..., :cout], buf=buf)
            buf, cin = nxt, cout
        if stage in cfg.out_stages:
            outputs.append((x * q[f'stage{stage}_scale'])
                           .to(torch.bfloat16).permute(0, 3, 1, 2))
    return outputs
