"""Entry point: one streaming Far3D frame plus decode (the PyTorch twin of
``__graft_entry__.py:entry``).

    step, (state,) = entry()                # full Far3DConfig() on 'cuda'
    dets, state = step(state)               # first frame of a stream
    dets, state = step(state, prev_exists=torch.ones(1, device='cuda'))

The model carries seeded random weights in the reference checkpoint's layout
(``utils.convert.random_reference_state_dict``). It runs on the card unless
the caller passes ``device='cpu'``; without a card and without that request
it raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import Far3DConfig
from .models.detector import Far3D, decode_detections
from .models.farhead import init_state
from .utils.convert import random_reference_state_dict
from .utils.synthetic import inference_inputs


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


def build_model(cfg: Far3DConfig, device, seed: int = 0) -> Far3D:
    """Far3D on `device` with seeded random reference-keyed weights; the
    parameters are allocated once, on the target device."""
    with torch.device('meta'):
        model = Far3D(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(random_reference_state_dict(cfg, seed))
    return model.eval()


@torch.inference_mode()
def run_frame(model: Far3D, state, **inputs):
    """One streaming frame and its NMS-free decode -> (detections, state)."""
    out = model(state=state, **inputs)
    dets = decode_detections(out['all_cls_scores'][-1],
                             out['all_bbox_preds'][-1], out['query_valid'],
                             model.cfg)
    return dets, out['state']


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
