"""The Far3D training and inference steps (counterpart of
``far3d_tpu/train/step.py``: ``create_train_state``, ``make_train_step`` and
``make_infer_step``).

One step: normalize uint8 images, grid mask, bf16 images when
``cfg.train.dtype == 'bfloat16'``, denoising queries, the forward in training
mode, the 3D set losses and the YOLOX / DDN 2D losses summed in the JAX
package's order (sorted keys, as ``jax.tree_util.tree_leaves`` of the loss
dict), the backward, optax's clip and AdamW update, and the next temporal
state, detached.

Randomness. ``draw_step_noise`` takes the grid-mask and DN draws from one
``torch.Generator``; ``step_from_noise`` is deterministic given them, so a
test can hand in the JAX step's draws. Dropout draws from a second generator
on the model's device, passed to the forward. The state is a model, its
optimizer and a step count, updated in place and returned.

The step's parts are labelled with ``torch.profiler.record_function``
(train.inputs, train.forward, train.loss_3d, which holds the matching's
auction and its convergence tests, train.loss_2d, train.backward,
train.optimizer, which holds train.grad_all_reduce) so that
``tools/profile_torch_port.py --train`` can say where a step's time goes;
outside a profiler a label costs a few microseconds of host time.

Data parallelism (``parallel/mesh.py``): each rank steps on its lanes of the
global batch. ``train_step`` draws the DN noise for the global batch from
the generator, seeded alike on every rank, and keeps the rank's lanes, so a
rank draws what one process would draw for those lanes; the grid mask is
one draw a step, the same on every rank, as in the JAX step. The BN
statistics, the loss normalizers and the gradients are the global batch's
(``models/layers.py``, ``losses{2d,3d}.py``, ``optim.py``) and the metrics
are the ranks' mean, so they read as the JAX step's on the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..config import Far3DConfig
from ..models.detector import Far3D, decode_detections, level_shapes
from ..models.farhead import TemporalState, init_state
from ..models.heads2d import make_priors
from ..ops import grid_mask
from ..parallel import mesh
from .dn import build_queries, draw_noise
from .losses2d import yolox_loss
from .losses3d import farhead_loss
from .optim import clip_and_step, ema_update, make_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: Far3D                       # parameters and the YOLOX BN stats
    optimizer: torch.optim.AdamW
    ema: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(cfg: Far3DConfig, model: Far3D, batch: int = 1
                       ) -> Tuple[TrainState, TemporalState]:
    """A train state around `model` (already on its device) and a fresh
    temporal state for `batch` streams."""
    device = next(model.parameters()).device
    optimizer = make_optimizer(model, cfg.train)
    ema = None
    if cfg.train.ema_decay > 0:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return (TrainState(0, model, optimizer, ema),
            init_state(batch, cfg.head, device))


def draw_step_noise(cfg: Far3DConfig, batch: int,
                    generator: torch.Generator) -> Dict[str, Any]:
    """The step's grid-mask and DN draws (step.py:98-118), on the generator's
    device; None for a part that the config switches off."""
    h = cfg.data.input_hw[0]
    return dict(
        grid_mask=(grid_mask.draw(h, cfg.train.grid_mask_prob, generator)
                   if cfg.train.use_grid_mask else None),
        dn=draw_noise(batch, cfg.head, generator) if cfg.head.with_dn else None)


def step_from_noise(cfg: Far3DConfig, state: TrainState,
                    tstate: TemporalState, batch: Dict[str, torch.Tensor],
                    noise: Dict[str, Any],
                    dropout_generator: Optional[torch.Generator] = None,
                    use_gt_depth: bool = True
                    ) -> Tuple[TrainState, TemporalState, Dict[str, torch.Tensor]]:
    """One training step given the step's draws (see the module docstring).
    `batch` holds the keys of ``utils.synthetic.synthetic_batch`` on the
    model's device. Returns (state, next temporal state, metrics: every loss
    term, ``total_loss`` and the unclipped ``grad_norm``). With
    `use_gt_depth` the 2D proposals sit at their GT depth, as in the
    reference until its UseGtDepthHook switches that off (the runner's
    ``use_gt_depth_until_iter``); without, at the depth net's top bins."""
    model = state.model
    dev = next(model.parameters()).device
    with record_function('train.inputs'):
        images = batch['images']
        if not images.is_floating_point():
            # uint8 transport: normalize before the grid mask, so masked
            # cells are 0 after normalization (step.py:101-107)
            mean = torch.tensor(cfg.data.img_mean, device=dev)
            std = torch.tensor(cfg.data.img_std, device=dev)
            images = (images.float() - mean) / std
        if noise.get('grid_mask') is not None:
            images = grid_mask.apply(images, **noise['grid_mask'])
        if cfg.train.dtype == 'bfloat16':
            images = images.to(torch.bfloat16)
        dn = None
        if noise.get('dn') is not None:
            dn = build_queries({k: v.to(dev) for k, v in noise['dn'].items()},
                               batch['gt_boxes'], batch['gt_labels'],
                               batch['gt_mask'], cfg.head, cfg.pc_range)
        b, n = images.shape[:2]
        priors = make_priors(level_shapes(cfg), cfg.strides, device=dev)

    with record_function('train.forward'):
        out = model(images=images, lidar2img=batch['lidar2img'],
                    intrinsics=batch['intrinsics'],
                    extrinsics=batch['extrinsics'], state=tstate,
                    prev_exists=batch['prev_exists'],
                    timestamp=batch['timestamp'], ego_pose=batch['ego_pose'],
                    ego_pose_inv=batch['ego_pose_inv'],
                    gt_depth_bins=batch['gt_depth_bins'],
                    dn_ref_points=None if dn is None else dn['ref_points'],
                    dn_valid=None if dn is None else dn['valid'],
                    use_gt_depth=use_gt_depth, train=True,
                    generator=dropout_generator)
    with record_function('train.loss_3d'):
        losses = farhead_loss(out, batch['gt_boxes'], batch['gt_labels'],
                              batch['gt_mask'], dn, cfg.head)
    with record_function('train.loss_2d'):
        g2 = batch['gt_boxes2d'].shape[2]
        losses.update(yolox_loss(
            out['outs2d'], priors,
            batch['gt_boxes2d'].reshape(b * n, g2, 4),
            batch['gt_labels2d'].reshape(b * n, g2),
            batch['gt_centers2d'].reshape(b * n, g2, 2),
            batch['gt_mask2d'].reshape(b * n, g2),
            batch['gt_depth_bins'].reshape(b * n, -1),
            batch['gt_depth_fg'].reshape(b * n, -1), cfg.roi2d))
        total = sum(losses[k] for k in sorted(losses))

    with record_function('train.backward'):
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
    with record_function('train.optimizer'):
        grad_norm = clip_and_step(state.optimizer, cfg.train, state.step)
        if state.ema is not None:
            ema_update(state.ema, model, state.step, cfg.train.ema_decay)
    state.step += 1

    metrics = {k: v.detach() for k, v in losses.items()}
    metrics['total_loss'] = total.detach()
    metrics = mesh.mean_over_ranks(metrics)
    metrics['grad_norm'] = grad_norm.detach()
    new_t = out['state']
    new_t = TemporalState(**{f.name: getattr(new_t, f.name).detach()
                             for f in dataclasses.fields(TemporalState)})
    return state, new_t, metrics


def train_step(cfg: Far3DConfig, state: TrainState, tstate: TemporalState,
               batch: Dict[str, torch.Tensor], generator: torch.Generator,
               dropout_generator: Optional[torch.Generator] = None,
               use_gt_depth: bool = True):
    """``draw_step_noise`` for the global batch, the rank's lanes of it,
    then ``step_from_noise``."""
    rank, world = mesh.rank_and_world()
    noise = mesh.shard_batch(draw_step_noise(
        cfg, batch['images'].shape[0] * world, generator), rank, world)
    return step_from_noise(cfg, state, tstate, batch, noise,
                           dropout_generator, use_gt_depth)


def make_infer_step(cfg: Far3DConfig):
    """Streaming inference step (reference simple_test_pts, far3d.py:244-266):
    ``infer_step(model, tstate, batch, quant_tree=None) -> (detections,
    tstate)``. `batch` holds the model inputs (images uint8, or normalized in
    any float dtype) on the model's device; the detections are
    ``decode_detections``'. `quant_tree` (``ops/quant.py``) runs the int8
    backbone in place of the bf16 one."""

    @torch.inference_mode()
    def infer_step(model: Far3D, tstate: TemporalState,
                   batch: Dict[str, torch.Tensor], quant_tree=None):
        out = model(images=batch['images'], lidar2img=batch['lidar2img'],
                    intrinsics=batch['intrinsics'],
                    extrinsics=batch['extrinsics'], state=tstate,
                    prev_exists=batch['prev_exists'],
                    timestamp=batch['timestamp'], ego_pose=batch['ego_pose'],
                    ego_pose_inv=batch['ego_pose_inv'],
                    quant_backbone=quant_tree)
        dets = decode_detections(out['all_cls_scores'][-1],
                                 out['all_bbox_preds'][-1],
                                 out['query_valid'], cfg)
        return dets, out['state']

    return infer_step
