"""Entry points: one streaming Far3D frame plus decode (the PyTorch twin of
``__graft_entry__.py:entry``), one training step, and the same two for
StreamPETR.

    step, (state,) = entry()                # full Far3DConfig() on 'cuda'
    dets, state = step(state)               # first frame of a stream
    dets, state = step(state, prev_exists=torch.ones(1, device='cuda'))

    step, (train_state, tstate) = train_entry()
    train_state, tstate, metrics = step(train_state, tstate)

    step, (state,) = petr_entry()           # full StreamPETRConfig()
    dets, state = step(state, quant_tree=tree)   # tree: quantize_petr_backbone
    step, (train_state, tstate) = petr_train_entry()

The models carry seeded random weights (``utils.convert``'s
``random_reference_state_dict`` and ``random_petr_state_dict``). They run on
the card unless the caller passes ``device='cpu'``; without a card and
without that request they raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .config import Far3DConfig
from .models.detector import Far3D
from .models.farhead import init_state
from .train.step import create_train_state, make_infer_step, train_step
from .utils.convert import random_reference_state_dict
from .utils.synthetic import inference_inputs, synthetic_batch


def resolve_device(device=None) -> torch.device:
    """'cuda' by default; raises when no card is present and the caller did
    not ask for another device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('far3d_tpu_torch runs on a CUDA device and none '
                               "is available; pass device='cpu' to run on "
                               'the CPU')
        device = 'cuda'
    return torch.device(device)


def build_model(cfg: Far3DConfig, device, seed: int = 0,
                weights: Optional[Dict[str, torch.Tensor]] = None) -> Far3D:
    """Far3D on `device` with `weights` (a reference-keyed state dict;
    default: seeded random ones); the parameters are allocated once, on the
    target device."""
    with torch.device('meta'):
        model = Far3D(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(random_reference_state_dict(cfg, seed)
                          if weights is None else weights)
    return model.eval()


def run_frame(model: Far3D, state, **inputs):
    """One streaming frame and its NMS-free decode -> (detections, state),
    through ``train.step.make_infer_step``."""
    return make_infer_step(model.cfg)(model, state, inputs)


def entry(cfg: Optional[Far3DConfig] = None, device=None, seed: int = 0):
    """-> (step, (state,)): ``step(state, **overrides)`` runs one frame of the
    synthetic 7-camera inputs, images in bf16 (any input can be overridden,
    e.g. ``prev_exists``), and returns (detections, next state).
    ``step.model`` is the model."""
    cfg = Far3DConfig() if cfg is None else cfg
    device = resolve_device(device)
    model = build_model(cfg, device, seed)
    inputs = {k: torch.from_numpy(v).to(device)
              for k, v in inference_inputs(cfg, batch=1, seed=seed).items()}
    inputs['images'] = inputs['images'].to(torch.bfloat16)

    def step(state, **overrides):
        return run_frame(model, state, **{**inputs, **overrides})

    step.model = model
    return step, (init_state(1, cfg.head, device),)


def train_entry(cfg: Optional[Far3DConfig] = None, device=None, seed: int = 0):
    """-> (step, (train_state, temporal_state)): ``step(train_state,
    temporal_state)`` takes one training step (AdamW, DN, grid mask, dropout,
    GT depth, all losses) on the seeded synthetic batch ``synthetic_batch(cfg,
    1, seed)`` and returns (train_state, next temporal state, metrics).
    Grid-mask and DN draws come from a CPU generator, dropout from one on the
    device, both seeded with `seed`."""
    cfg = Far3DConfig() if cfg is None else cfg
    device = resolve_device(device)
    model = build_model(cfg, device, seed)
    batch = {k: v.to(device) for k, v in synthetic_batch(cfg, 1, seed).items()}
    noise_gen = torch.Generator().manual_seed(seed)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    def step(train_state, tstate):
        return train_step(cfg, train_state, tstate, batch, noise_gen,
                          dropout_gen)

    return step, create_train_state(cfg, model, batch=1)


def build_petr_model(cfg, device, seed: int = 0,
                     weights: Optional[Dict[str, torch.Tensor]] = None):
    """StreamPETR on `device` with `weights` (default: seeded random ones),
    allocated once, on the target device; a ``StreamPETRViTConfig`` builds
    the ViT model (``models/streampetr_vit.py``)."""
    from .models.streampetr import StreamPETR
    from .models.streampetr_vit import (StreamPETRViT, StreamPETRViTConfig,
                                        random_vit_petr_state_dict)
    from .utils.convert import random_petr_state_dict
    vit = isinstance(cfg, StreamPETRViTConfig)
    with torch.device('meta'):
        model = (StreamPETRViT if vit else StreamPETR)(cfg)
    model = model.to_empty(device=device)
    if weights is None:
        weights = (random_vit_petr_state_dict if vit
                   else random_petr_state_dict)(cfg, seed)
    model.load_state_dict(weights)
    return model.eval()


def petr_entry(cfg=None, device=None, seed: int = 0):
    """-> (step, (state,)): ``step(state, quant_tree=None, **overrides)``
    runs one StreamPETR frame of the synthetic 6-camera inputs, images in
    bf16, and its decode, and returns (detections, next state); with
    `quant_tree` (``ops.quant.quantize_petr_backbone(step.model, ...)``)
    the int8 backbone serves. ``step.model`` is the model, ``step.infer``
    the ``make_petr_infer_step`` step it runs frames through."""
    from .models.streampetr import StreamPETRConfig, init_petr_state
    from .train.petr_step import make_petr_infer_step
    from .utils.synthetic import petr_inference_inputs
    cfg = StreamPETRConfig() if cfg is None else cfg
    device = resolve_device(device)
    model = build_petr_model(cfg, device, seed)
    inputs = {k: torch.from_numpy(v).to(device)
              for k, v in petr_inference_inputs(cfg, 1, seed).items()}
    inputs['images'] = inputs['images'].to(torch.bfloat16)
    infer = make_petr_infer_step(cfg)

    def step(state, quant_tree=None, **overrides):
        return infer(model, state, {**inputs, **overrides}, quant_tree)

    step.model, step.infer = model, infer
    return step, (init_petr_state(1, cfg, device),)


def petr_train_entry(cfg=None, train_cfg=None, device=None, seed: int = 0):
    """-> (step, (train_state, temporal_state)): ``step(train_state,
    temporal_state)`` takes one StreamPETR training step (AdamW, grid mask,
    dropout, bf16 images) on the seeded synthetic batch
    ``petr_synthetic_batch(cfg, 1, seed)`` and returns (train_state, next
    temporal state, metrics). The grid-mask draw comes from a CPU
    generator, dropout from one on the device, both seeded with `seed`."""
    from .config import TrainConfig
    from .models.streampetr import StreamPETRConfig
    from .train.petr_step import create_petr_train_state, petr_train_step
    from .utils.synthetic import petr_synthetic_batch
    cfg = StreamPETRConfig() if cfg is None else cfg
    train_cfg = TrainConfig() if train_cfg is None else train_cfg
    device = resolve_device(device)
    model = build_petr_model(cfg, device, seed)
    batch = {k: v.to(device) for k, v in petr_synthetic_batch(
        cfg, 1, seed, max_gt=160).items()}
    noise_gen = torch.Generator().manual_seed(seed)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    def step(train_state, tstate):
        return petr_train_step(cfg, train_cfg, train_state, tstate, batch,
                               noise_gen, dropout_gen)

    return step, create_petr_train_state(model, train_cfg, batch=1)
