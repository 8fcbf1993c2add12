"""The training driver: full-width training steps at batch 1 through the
program's ``train.step.step_from_noise`` (AdamW, DN, grid mask, dropout,
GT depth, every loss), the temporal state carried from step to step.

Each step uploads its batch (a pool of seeded synthetic batches in pinned
host memory, cycled) and draws its grid-mask and DN noise from a seeded
CPU generator; dropout draws from a seeded generator on the card.
``step_ms`` is the window over the optimizer steps completed in it.

Set-up builds one train state and drives it through its first
``checked_steps`` steps, which also warm every shape; the window goes on
with the same object. Those steps' total losses, the first gradient as
AdamW got it (its first moment after one step over 1 - beta1) and every
parameter's change over the steps are kept. Once the window has closed and
the program is freed, the reference takes the same weights, batches,
noise and dropout generator through the same steps in float32, and the
two are compared (``harness/compare.py``)."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from harness import (compare, family as fam, hooks, hostspeed, traffic as tr,
                     work)


class Trainer:
    """One side's train state and its step on the cell's traffic."""

    def __init__(self, family, cfg, weights, batches, seed, device):
        self.f, self.cfg, self.device = family, cfg, device
        model = family.build(weights, device)
        step_mod = family.mod('train.step')
        self.state, self.tstate = step_mod.create_train_state(cfg, model)
        self.step_fn = step_mod.step_from_noise
        self.draw = step_mod.draw_step_noise
        self.batches = batches
        self.noise_gen = torch.Generator().manual_seed(tr.sub_seed(seed, 5))
        self.dropout_gen = torch.Generator(device=device).manual_seed(
            tr.sub_seed(seed, 6))
        self.k = 0

    def step(self, noise=None):
        """One optimizer step; returns (metrics, the noise it used)."""
        host = self.batches[self.k % len(self.batches)]
        batch = {key: v.to(self.device, non_blocking=True)
                 for key, v in host.items()}
        batch['prev_exists'] = torch.full((1,), float(self.k > 0),
                                          device=self.device)
        if noise is None:
            noise = self.draw(self.cfg, 1, self.noise_gen)
        self.state, self.tstate, metrics = self.step_fn(
            self.cfg, self.state, self.tstate, batch, noise,
            self.dropout_gen)
        self.k += 1
        return metrics, noise

    def named(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.state.model.named_parameters())

    def first_moment_norms(self) -> Dict[str, float]:
        """Per leaf, the norm of AdamW's first moment over 1 - beta1: after
        one step, the clipped gradient the optimizer got."""
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]['betas'][0]
        out = {}
        for name, p in self.named().items():
            st = opt.state.get(p, {})
            m = st.get('exp_avg')
            out[name] = 0.0 if m is None else float(m.norm()) / (1 - beta1)
        return out


def change_norms(now: Dict[str, torch.Tensor],
                 before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float((now[k].detach() - before[k]).norm()) for k in before}


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device='cuda', control=None) -> Dict:
    """One run of a training cell. `control` puts the reference at the
    configuration's dtype in the program's place: with ``{'lower': True}``
    every convolution and linear layer one precision lower (the control),
    with ``{'lower': False}`` as it is (a second witness of what the
    configured precision reads); the readings and the control tests pass
    it, never a cell's run."""
    t = cell.traffic
    n_check = t['checked_steps']
    device = torch.device(device)
    port = fam.load(cell.config, 'port')
    ref_family = fam.load(cell.config, 'reference')
    batches = tr.train_batches(port.cfg, t, seed, device)
    weights = port.weights(seed, device)
    if control:                      # the reference at the config's dtype
        side, cfg = ref_family, ref_family.cfg
    else:
        side, cfg = port, port.cfg
    trainer = Trainer(side, cfg, weights, batches, seed, device)
    del weights
    before = {k: p.detach().clone() for k, p in trainer.named().items()}

    losses, noises, grads = [], [], None
    neck = {'neck': trainer.state.model.img_neck}
    for k in range(n_check):
        lower = (ref_family.mod('models.layers').one_step_lower()
                 if control and control.get('lower')
                 else contextlib.nullcontext())
        with lower, hooks.Capture(neck if k == 0 else {}) as cap:
            metrics, noise = trainer.step()
        losses.append(float(metrics['total_loss']))
        noises.append(noise)
        if k == 0:
            grads = trainer.first_moment_norms()
            probed = _detached(cap.out('neck'))
    changes = change_norms(trainer.named(), before)
    del before
    _sync(device)
    setup_s = time.perf_counter() - t_start

    gc.collect()        # set-up's objects out of the collector's sight
    gc.freeze()
    steps = 0
    host_before = hostspeed.snapshot()
    t0 = time.perf_counter()
    end = t0
    while end - t0 < seconds:
        trainer.step()
        _sync(device)       # a step ends when its update is done
        end = time.perf_counter()
        steps += 1
    window = end - t0
    hostspeed.report(host_before, hostspeed.snapshot())
    result = dict(attempted=steps, failed=0, setup_s=setup_s,
                  e2e={'step_ms': window / steps * 1e3}, steps=steps,
                  window_s=window)
    if trace:
        result['traced'] = traced_window(trainer, port, t)
    result['memory_peak_bytes'] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == 'cuda' else 0)
    del trainer
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    result['numbers'], result['flops'] = check(
        ref_family, t, seed, device, batches, noises,
        dict(losses=losses, grads=grads, changes=changes, probe=probed),
        count=trace)
    return result


def _detached(x):
    """A probed output (a tensor or a list of them) detached from the
    graph, so that keeping it keeps no activations."""
    if torch.is_tensor(x):
        return x.detach()
    return [t.detach() for t in x]


def _float32(cfg):
    return cfg.replace(train=dataclasses.replace(cfg.train, dtype='float32'))


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def traced_window(trainer: Trainer, port, t: Dict) -> Dict:
    """`trace_steps` more steps under the profiler, with decoder layer 0's
    MSDA operands captured; returns what the metrics read."""
    from harness.trace import Trace, host_span, profiled
    keep: Dict = {}
    model = trainer.state.model
    handle = hooks.first_backward_operands(port.train_sampler(model), keep)
    calls: List = []
    counting = [m.register_forward_hook(
        lambda m, a, out: calls.append(1) if out.requires_grad else None)
        for m in hooks.msda_modules(model)]
    n = t['trace_steps']

    def steps():
        with record_function('bench.window'):
            for _ in range(n):
                with record_function('bench.step'):
                    trainer.step()
                    torch.cuda.synchronize()

    try:
        _, events = profiled(steps)
    finally:
        handle.remove()
        for h in counting:
            h.remove()
    bwd = None
    if 'args' in keep:
        shapes, value, loc, weights = keep['args']
        nbytes, flops = work.msda_bwd_needs(value, shapes, loc, weights)
        bwd = dict(bytes=nbytes, flops=flops)
    return dict(trace=Trace(events, host_span(events, 'bench.window')),
                steps=n, msda_bwd_one_call=bwd, msda_bwd_calls=len(calls))


def check(ref_family, t, seed, device, batches, noises, prog: Dict,
          count: bool):
    """The reference's first steps from the same weights, batches, noise
    and dropout draws in float32; returns (compared numbers, FLOP of one
    forward when `count`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _float32(ref_family.cfg)
    weights = ref_family.weights(seed, device)
    ref = Trainer(ref_family, cfg, weights, batches, seed, device)
    del weights
    before = {k: p.detach().clone() for k, p in ref.named().items()}
    flops = None
    losses, grads = [], None
    neck = {'neck': ref.state.model.img_neck}
    for k, noise in enumerate(noises):
        with hooks.Capture(neck if k == 0 else {}) as cap:
            metrics, _ = ref.step(noise)
        losses.append(float(metrics['total_loss']))
        if k == 0:
            grads = ref.first_moment_norms()
            probed = _detached(cap.out('neck'))
    changes = change_norms(ref.named(), before)
    if count:
        flops = count_forward(ref, noises[0])
    med = sorted(grads.values())[len(grads) // 2]
    still = [k for k, g in grads.items() if g < 1e-3 * med]
    numbers = dict(
        neck_rel=compare.worst_rel(prog['probe'], probed),
        loss=max(compare.rel_gap(a, b) for a, b in zip(prog['losses'],
                                                        losses)),
        grad_leaf=compare.leaf_gaps(prog['grads'], grads),
        grad_leaf_median=compare.leaf_gaps(prog['grads'], grads, q=0.5),
        change_leaf=compare.leaf_gaps(prog['changes'], changes, skip=still),
        change_leaf_median=compare.leaf_gaps(prog['changes'], changes,
                                             skip=still, q=0.5),
        steps_checked=len(noises), leaves_left_out=len(still))
    return numbers, flops


def count_forward(trainer: Trainer, noise) -> Dict:
    """FLOP of one training forward of the reference (matmuls,
    convolutions, attention, and the MSDA sampling from its operands),
    without stepping, after the compared steps (a training forward moves
    the BN statistics)."""
    model = trainer.state.model
    msda_ops: List = []
    handles = hooks.capture_msda(hooks.msda_modules(model), msda_ops,
                                 limit=10 ** 6)
    host = trainer.batches[0]
    batch = {key: v.to(trainer.device) for key, v in host.items()}
    cfg = trainer.cfg

    def forward():
        with torch.no_grad():
            dn = None
            if noise.get('dn') is not None:
                dn = trainer.f.mod('train.dn').build_queries(
                    {k: v.to(trainer.device) for k, v in noise['dn'].items()},
                    batch['gt_boxes'], batch['gt_labels'], batch['gt_mask'],
                    cfg.head, cfg.pc_range)
            images = batch['images']
            mean = torch.tensor(cfg.data.img_mean, device=trainer.device)
            std = torch.tensor(cfg.data.img_std, device=trainer.device)
            images = (images.float() - mean) / std
            model(images=images, lidar2img=batch['lidar2img'],
                  intrinsics=batch['intrinsics'],
                  extrinsics=batch['extrinsics'], state=trainer.tstate,
                  prev_exists=batch['prev_exists'],
                  timestamp=batch['timestamp'], ego_pose=batch['ego_pose'],
                  ego_pose_inv=batch['ego_pose_inv'],
                  gt_depth_bins=batch['gt_depth_bins'],
                  dn_ref_points=None if dn is None else dn['ref_points'],
                  dn_valid=None if dn is None else dn['valid'],
                  use_gt_depth=True, train=True,
                  generator=trainer.dropout_gen)
    try:
        _, counted = work.count_flops(forward)
    finally:
        for h in handles:
            h.remove()
    sampling = sum(work.msda_sampling_flops(loc.shape[0], loc.shape[1],
                                            len(shapes), loc.shape[2],
                                            value.shape[2])
                   for shapes, value, loc, _ in msda_ops)
    return dict(float_flops=counted + sampling, int8_ops=0)
