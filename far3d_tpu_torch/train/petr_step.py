"""The StreamPETR training and inference steps (counterpart of
``far3d_tpu/train/petr_step.py`` and of ``eval/petr_runner.py``'s jitted
step).

One training step, in the JAX package's order: normalize uint8 images with
the module-level mean and std, the grid mask, bf16 images when
``train_cfg.dtype == 'bfloat16'``, the 10-dim targets (gravity-centre box and
velocity), the forward in training mode, ``farhead_loss`` with no DN branch
(the JAX loss is duck-typed on the config: ``code_weights`` with the
velocity terms at 0.2, ``num_classes`` 10), the losses summed in sorted-key
order, the backward, optax's clip and AdamW with the backbone multiplier and
the frozen ``pseudo_reference_points`` (``train/optim.py``), the EMA, and the
next temporal state, detached. The train state is ``train/step.py``'s
``TrainState`` around a ``StreamPETR``, so ``utils/checkpoint.py`` and the
runner's loop serve both families.

Randomness: ``draw_petr_noise`` takes the grid-mask draw from a
``torch.Generator``; ``petr_step_from_noise`` is deterministic given it and
the dropout generator on the model's device.

Data parallelism is ``train/step.py``'s: one grid-mask draw a step, the
same on every rank; the loss normalizers the global batch's
(``farhead_loss``), the gradients averaged over the ranks
(``clip_and_step``), the metrics the ranks' mean (the twin of
``tools/train_nusc.py:49-97`` on the JAX mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..config import IMG_MEAN, IMG_STD, TrainConfig
from ..models.detector import decode_boxes
from ..models.farhead import TemporalState
from ..models.streampetr import StreamPETR, StreamPETRConfig, init_petr_state
from ..ops import grid_mask
from ..parallel import mesh
from .losses3d import farhead_loss
from .optim import clip_and_step, ema_update, make_optimizer
from .step import TrainState


def create_petr_train_state(model: StreamPETR, train_cfg: TrainConfig,
                            batch: int = 1
                            ) -> Tuple[TrainState, TemporalState]:
    """A train state around `model` (already on its device) and a fresh
    temporal state for `batch` streams."""
    device = next(model.parameters()).device
    ema = None
    if train_cfg.ema_decay > 0:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return (TrainState(0, model, make_optimizer(model, train_cfg), ema),
            init_petr_state(batch, model.cfg, device))


def draw_petr_noise(cfg: StreamPETRConfig, train_cfg: TrainConfig,
                    generator: torch.Generator) -> Dict[str, Any]:
    """The step's grid-mask draw (petr_step.py:70-79), None when off."""
    return dict(grid_mask=(
        grid_mask.draw(cfg.input_hw[0], train_cfg.grid_mask_prob, generator)
        if train_cfg.use_grid_mask else None))


def petr_step_from_noise(cfg: StreamPETRConfig, train_cfg: TrainConfig,
                         state: TrainState, tstate: TemporalState,
                         batch: Dict[str, torch.Tensor],
                         noise: Dict[str, Any],
                         dropout_generator: Optional[torch.Generator] = None
                         ) -> Tuple[TrainState, TemporalState,
                                    Dict[str, torch.Tensor]]:
    """One training step given its draws. `batch` holds the 3D keys of
    ``utils.synthetic.synthetic_batch`` (images, lidar2img, timestamp,
    prev_exists, ego poses, gt_boxes, gt_velocity, gt_labels, gt_mask) on
    the model's device. Returns (state, next temporal state, metrics: every
    loss term, ``total_loss`` and the unclipped ``grad_norm``)."""
    model = state.model
    dev = next(model.parameters()).device
    with record_function('train.inputs'):
        images = batch['images']
        if not images.is_floating_point():
            mean = torch.tensor(IMG_MEAN, device=dev)
            std = torch.tensor(IMG_STD, device=dev)
            images = (images.float() - mean) / std
        if noise.get('grid_mask') is not None:
            images = grid_mask.apply(images, **noise['grid_mask'])
        if train_cfg.dtype == 'bfloat16':
            images = images.to(torch.bfloat16)
        gt_boxes9 = torch.cat([batch['gt_boxes'], batch['gt_velocity']],
                              dim=-1)
    with record_function('train.forward'):
        out = model(images=images, lidar2img=batch['lidar2img'],
                    state=tstate, prev_exists=batch['prev_exists'],
                    timestamp=batch['timestamp'], ego_pose=batch['ego_pose'],
                    ego_pose_inv=batch['ego_pose_inv'], train=True,
                    generator=dropout_generator)
    with record_function('train.loss_3d'):
        losses = farhead_loss(out, gt_boxes9, batch['gt_labels'],
                              batch['gt_mask'], None, cfg)
        total = sum(losses[k] for k in sorted(losses))
    with record_function('train.backward'):
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
    with record_function('train.optimizer'):
        grad_norm = clip_and_step(state.optimizer, train_cfg, state.step)
        if state.ema is not None:
            ema_update(state.ema, model, state.step, train_cfg.ema_decay)
    state.step += 1

    metrics = {k: v.detach() for k, v in losses.items()}
    metrics['total_loss'] = total.detach()
    metrics = mesh.mean_over_ranks(metrics)
    metrics['grad_norm'] = grad_norm.detach()
    new_t = out['state']
    new_t = TemporalState(**{f.name: getattr(new_t, f.name).detach()
                             for f in dataclasses.fields(TemporalState)})
    return state, new_t, metrics


def petr_train_step(cfg: StreamPETRConfig, train_cfg: TrainConfig,
                    state: TrainState, tstate: TemporalState,
                    batch: Dict[str, torch.Tensor],
                    generator: torch.Generator,
                    dropout_generator: Optional[torch.Generator] = None):
    """``draw_petr_noise`` then ``petr_step_from_noise``."""
    return petr_step_from_noise(cfg, train_cfg, state, tstate, batch,
                                draw_petr_noise(cfg, train_cfg, generator),
                                dropout_generator)


def make_petr_infer_step(cfg: StreamPETRConfig):
    """Streaming StreamPETR step with its NMS-free decode
    (petr_runner.py:58-72): ``infer_step(model, tstate, batch,
    quant_tree=None) -> (detections, tstate)``; `quant_tree`
    (``ops/quant.py:quantize_petr_backbone``) serves with the int8
    backbone."""

    @torch.inference_mode()
    def infer_step(model: StreamPETR, tstate: TemporalState,
                   batch: Dict[str, torch.Tensor], quant_tree=None):
        out = model(images=batch['images'], lidar2img=batch['lidar2img'],
                    state=tstate, prev_exists=batch['prev_exists'],
                    timestamp=batch['timestamp'], ego_pose=batch['ego_pose'],
                    ego_pose_inv=batch['ego_pose_inv'],
                    quant_backbone=quant_tree)
        dets = decode_boxes(out['all_cls_scores'][-1],
                            out['all_bbox_preds'][-1], out['query_valid'],
                            cfg.max_decode_num, cfg.post_center_range)
        return dets, out['state']

    return infer_step
