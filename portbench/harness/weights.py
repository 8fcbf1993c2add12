"""Seeded random weights made on the device, in a few large draws.

The rule per key is that of the port's seeded weights (fan-in scaled
weights, norm scales near 1, BN statistics in a narrow range, reference
points uniform in the unit cube, small biases, the YOLOX objectness bias
near -1 so that a moderate number of 2D proposals pass the threshold), so a
deep stack stays finite. The draws are two flat tensors from one
``torch.Generator`` on the card, cut into the keys' shapes in the state
dict's order: the same seed gives the same weights, and the program and
the reference get the same tensors."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _kind(key: str, shape: Tuple[int, ...]) -> str:
    if 'running_var' in key:
        return 'var'
    if 'running_mean' in key:
        return 'mean'
    if 'reference_points' in key:
        return 'unit'
    if 'conv_obj' in key and key.endswith('.bias'):
        return 'obj_bias'
    if key.endswith('.weight') and len(shape) == 1:
        return 'scale'
    if key.endswith('.weight'):
        return 'fan_in'
    return 'bias'


def seeded_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """{key: float32 tensor of its shape} on `device` from `seed`."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        kind = _kind(key, shape)
        if kind == 'var':
            v = 0.5 + u
        elif kind == 'mean':
            v = 0.1 * z
        elif kind == 'unit':
            v = u
        elif kind == 'obj_bias':
            v = 0.5 * z - 1.0
        elif kind == 'scale':
            v = 0.75 + 0.5 * u
        elif kind == 'fan_in':
            v = z / math.sqrt(math.prod(shape[1:]))
        else:
            v = 0.1 * z
        out[key] = v.clone()
    del normal, uniform
    return out


def state_shapes(model_cls, cfg) -> Dict[str, Tuple[int, ...]]:
    """The state dict's keys and shapes of ``model_cls(cfg)``, built on the
    meta device (no memory)."""
    with torch.device('meta'):
        sd = model_cls(cfg).state_dict()
    return {k: tuple(v.shape) for k, v in sd.items()}
