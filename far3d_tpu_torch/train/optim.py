"""Optimizer and learning-rate schedule (counterpart of
``far3d_tpu/train/optim.py``; reference far3d.py:260-276 and mmcv hooks).

The JAX package's optax chain, reproduced step for step:
  * clip by global norm 35 with optax's formula: g * 35 / norm when norm >=
    35, no epsilon (``clip_grad_norm_`` adds 1e-6, so it is not used);
  * Adam (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight decay 0.01 on
    every parameter, norms and biases included: ``torch.optim.AdamW``
    computes p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), which is
    optax's scale_by_adam -> add_decayed_weights -> scale_by_learning_rate;
  * learning rate x 0.1 for the backbone (``img_backbone.*``);
  * ``pseudo_reference_points`` frozen: no gradient, no update, no decay;
  * the schedule: linear from lr * warmup_ratio to lr over warmup_iters,
    then cosine to lr * min_lr_ratio, evaluated at optax's count (0 for the
    first update);
  * an optional EMA of the parameters with the (1 + step) / (10 + step)
    ramp (off by default);
  * layer-wise LR decay (``layer_decay != 1``, optim.py:60-75,84-101; unused
    by the shipped config): a group per backbone depth i of n = 4 (the stem
    and stage 2 at 0, stages 3-5 at 1-3) and the rest at n, each at
    lr x decay^(n - i), in place of the backbone multiplier; the frozen
    parameters stay frozen.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ..config import TrainConfig
from ..parallel import mesh

FROZEN = ('pseudo_reference_points',)
BACKBONE_PREFIX = 'img_backbone.'


def lr_at(cfg: TrainConfig, step: int) -> float:
    """optax.join_schedules([linear warmup, cosine decay], [warmup_iters])
    at `step` (optim.py:23-30)."""
    if step < cfg.warmup_iters:
        frac = min(max(step, 0) / max(cfg.warmup_iters, 1), 1.0)
        start = cfg.lr * cfg.warmup_ratio
        return start + frac * (cfg.lr - start)
    decay_steps = max(cfg.total_iters - cfg.warmup_iters, 1)
    t = min(step - cfg.warmup_iters, decay_steps) / decay_steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * t))
    return cfg.lr * ((1.0 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)


def _freeze(model: nn.Module):
    """The trainable (name, parameter) pairs; freezes the FROZEN ones."""
    out = []
    for name, p in model.named_parameters():
        if any(f in name for f in FROZEN):
            p.requires_grad_(False)
        else:
            out.append((name, p))
    return out


def param_groups(model: nn.Module, cfg: TrainConfig) -> Tuple[Dict, Dict]:
    """(main, backbone) param groups; freezes the FROZEN parameters."""
    main, backbone = [], []
    for name, p in _freeze(model):
        (backbone if name.startswith(BACKBONE_PREFIX) else main).append(p)
    return ({'params': main, 'lr_mult': 1.0},
            {'params': backbone, 'lr_mult': cfg.backbone_lr_mult})


def layer_depth(name: str, num_layers: int) -> int:
    """make_layerwise_decay_labels (optim.py:84-101) for a port parameter
    name: the depth of a backbone parameter (stem 0, stage s at s - 2, at
    most num_layers - 1), num_layers for every other one."""
    if not name.startswith(BACKBONE_PREFIX):
        return num_layers
    top = name[len(BACKBONE_PREFIX):].split('.')[0]
    if top.startswith('stage') and top[5:].isdigit():
        return min(int(top[5:]) - 2, num_layers - 1)
    return 0


def layer_decay_groups(model: nn.Module, cfg: TrainConfig,
                       num_layers: int = 4) -> List[Dict]:
    """A group per depth with lr_mult = decay^(num_layers - depth); freezes
    the FROZEN parameters."""
    by_depth: Dict[int, List] = {}
    for name, p in _freeze(model):
        by_depth.setdefault(layer_depth(name, num_layers), []).append(p)
    return [{'params': by_depth[d],
             'lr_mult': cfg.layer_decay ** (num_layers - d)}
            for d in sorted(by_depth)]


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> torch.optim.AdamW:
    groups = (layer_decay_groups(model, cfg) if cfg.layer_decay != 1.0
              else param_groups(model, cfg))
    return torch.optim.AdamW(groups, lr=lr_at(cfg, 0), betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares, in f32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_and_step(optimizer: torch.optim.AdamW, cfg: TrainConfig,
                  step: int) -> torch.Tensor:
    """Clip the gradients by global norm as optax does, set the scheduled
    learning rates for update number `step` (0-based) and step. Returns the
    unclipped global norm. A parameter that the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it, so that AdamW still decays it
    as optax does (StreamPETR leaves the FPN levels it does not read).

    Under data parallelism (``parallel/mesh.py``) the gradients are then
    averaged over the ranks in flat buckets, the twin of the all-reduce
    that XLA inserts under the JAX mesh: every rank fills its missing
    gradients first, so that all hand in one layout, and the norm, the clip
    and the update are then the same on every rank."""
    params = [p for group in optimizer.param_groups for p in group['params']]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    with record_function('train.grad_all_reduce'):
        mesh.all_reduce_mean_(grads)
    norm = global_norm(grads)
    scale = torch.where(norm < cfg.grad_clip_norm, torch.ones_like(norm),
                        cfg.grad_clip_norm / norm)
    torch._foreach_mul_(grads, scale)
    lr = lr_at(cfg, step)
    for group in optimizer.param_groups:
        group['lr'] = lr * group['lr_mult']
    optimizer.step()
    return norm


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, step: int,
               decay: float) -> None:
    """EMA shadow with the warmup ramp d = min(decay, (1 + step) /
    (10 + step)) (step.py:159-165); `step` is the pre-update step count."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    for name, p in model.named_parameters():
        ema[name].mul_(d).add_(p.detach(), alpha=1.0 - d)
