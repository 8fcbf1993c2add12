"""Faults planted in the program underneath a run, for the tests that
show each fault a cell can have makes ``correct`` false (and for the
readings of a fault on the card). Each patches a function of
``far3d_tpu_torch`` for the duration of a ``with`` block.

- ``state_unchanged``: the streaming step returns the temporal state it
  was given; in training, the optimizer's update is dropped (the norm is
  taken, nothing moves).
- ``answer_altered``: every served detection's box moved 20 m along x
  where the step produces it; in training, every loss term scaled by 1.5
  (a wrong normalizer).
- ``memory_unaligned`` (serving): the memory carried into a frame is not
  moved into the current ego frame (the alignment takes the identity for
  the inverse ego pose).
- ``lift_moved`` (Far3D serving): every lifted 2D proposal's reference
  point moved by 1% of the range, as a wrong depth bin would.
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def _patched(module: str, name: str, value):
    mod = importlib.import_module(module)
    old = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, old)


def _memory_unaligned():
    farhead = importlib.import_module('far3d_tpu_torch.models.farhead')
    align = farhead.pre_update_memory_fn

    def unaligned(state, prev_exists, timestamp, ego_pose_inv, *rest):
        eye = torch.eye(4, dtype=ego_pose_inv.dtype,
                        device=ego_pose_inv.device).expand_as(ego_pose_inv)
        return align(state, prev_exists, timestamp, eye, *rest)
    stack = contextlib.ExitStack()
    for module in ('far3d_tpu_torch.models.farhead',
                   'far3d_tpu_torch.models.streampetr'):
        stack.enter_context(_patched(module, 'pre_update_memory_fn',
                                     unaligned))
    return stack


def _lift_moved():
    module = 'far3d_tpu_torch.models.farhead'
    lift = importlib.import_module(module).build_query2d_proposals

    def moved(*args, **kwargs):
        ref, ctx, valid = lift(*args, **kwargs)
        return ref + 0.01, ctx, valid
    return _patched(module, 'build_query2d_proposals', moved)


STREAM_ONLY = {'memory_unaligned': _memory_unaligned,
               'lift_moved': _lift_moved}


def plant(kind: str, family: str, fault: str):
    """The fault `fault` for a cell of traffic kind `kind` ('stream' or
    'train') and configuration family `family`, as a context manager."""
    if fault in STREAM_ONLY:
        if kind != 'stream' or (fault == 'lift_moved' and family != 'far3d'):
            raise ValueError(f'no fault {fault} in a {family} {kind} cell')
        return STREAM_ONLY[fault]()
    if kind == 'stream':
        module, name = (('far3d_tpu_torch.train.step', 'make_infer_step')
                        if family == 'far3d' else
                        ('far3d_tpu_torch.train.petr_step',
                         'make_petr_infer_step'))
        make = getattr(importlib.import_module(module), name)

        def broken(cfg):
            step = make(cfg)

            def run(model, tstate, batch, quant_tree=None):
                dets, new = step(model, tstate, batch, quant_tree)
                if fault == 'state_unchanged':
                    return dets, tstate
                dets = dict(dets)
                dets['boxes'] = dets['boxes'].clone()
                dets['boxes'][..., 0] += 20.0
                return dets, new
            return run
        return _patched(module, name, broken)

    step = importlib.import_module('far3d_tpu_torch.train.step')
    if fault == 'state_unchanged':
        from far3d_tpu_torch.train import optim

        def no_update(opt, cfg, k):
            return optim.global_norm([p.grad for g in opt.param_groups
                                      for p in g['params']
                                      if p.grad is not None])
        return _patched(step.__name__, 'clip_and_step', no_update)
    stack = contextlib.ExitStack()
    for name in ('farhead_loss', 'yolox_loss'):
        loss = getattr(step, name)

        def scaled(*args, _loss=loss, **kwargs):
            return {k: v * 1.5 for k, v in _loss(*args, **kwargs).items()}
        stack.enter_context(_patched(step.__name__, name, scaled))
    return stack
