"""Training loop (counterpart of ``far3d_tpu/train/runner.py``; replaces mmcv
IterBasedRunner + hooks, core/apis/mmdet_train.py:31-204).

The reference's hook stack, realized directly:
  * Fp16OptimizerHook        -> bf16 image side, f32 parameters
  * LR hooks                 -> ``train/optim.py``'s schedule
  * CheckpointHook           -> ``utils/checkpoint.py``, a save call each step
  * UseGtDepthHook (22000)   -> ``use_gt_depth`` off from
                                ``use_gt_depth_until_iter`` on
  * log hooks                -> ``metrics.jsonl`` every ``log_every`` steps
  * IterTimerHook            -> its ``time`` and ``data_time`` keys
  * profiler                 -> an optional ``torch.profiler`` window

Randomness: each step re-seeds a CPU generator (grid mask, DN) and one on
the device (dropout) from ``cfg.train.seed`` and the step number, as the JAX
step folds the step into its key (step.py:98-99), so a resumed run draws
what an uninterrupted one draws. One process, one device: data parallelism
across cards is not ported.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

import torch

from ..config import Far3DConfig
from ..entry import build_model, resolve_device
from ..utils.checkpoint import CheckpointManager
from ..utils.convert import init_state_dict, load_reference_checkpoint
from .step import TrainState, create_train_state, train_step

log = logging.getLogger('far3d_tpu_torch.train')


def step_seed(seed: int, step: int) -> int:
    """The generators' seed for step number `step` of a run seeded `seed`."""
    return (seed + 1) << 32 | step


def run_training(cfg: Far3DConfig,
                 loader,
                 work_dir: str,
                 batch_size: int,
                 resume: bool = True,
                 max_iters: Optional[int] = None,
                 profile_at: Optional[int] = None,
                 eval_fn=None,
                 load_from: Optional[str] = None,
                 device=None) -> TrainState:
    """Train until step `max_iters` (default ``cfg.train.total_iters``) on
    `loader`'s batches (dicts of CPU tensors, ``data.loader.TrainLoader``)
    and return the train state.

    The model starts from ``init_state_dict`` (seeded by
    ``cfg.train.seed``), then takes `load_from`'s tensors (a reference
    ``.pth``, loaded by key, the missing count logged), then, with `resume`,
    the latest checkpoint in `work_dir`. `eval_fn(state)` runs every
    ``checkpoint_every`` steps. The last step is always saved. `profile_at`
    traces steps profile_at .. profile_at + 2 into ``work_dir/trace.json``.
    Runs on the card unless `device` says otherwise."""
    tc = cfg.train
    max_iters = max_iters or tc.total_iters
    device = resolve_device(device)
    model = build_model(cfg, device, weights=init_state_dict(cfg, tc.seed))
    if load_from:
        missing, _ = model.load_state_dict(load_reference_checkpoint(load_from),
                                           strict=False)
        log.info('loaded %s (%d reference keys not found, kept init)',
                 load_from, len(missing))
    state, tstate = create_train_state(cfg, model, batch=batch_size)
    ckpt = CheckpointManager(work_dir, max_to_keep=tc.keep_checkpoints,
                             save_interval=tc.checkpoint_every)
    if resume and ckpt.restore(state) is not None:
        log.info('resumed from step %d', state.step)

    noise_gen = torch.Generator()
    dropout_gen = torch.Generator(device=device)
    window = max(tc.log_every, 1)
    prof = None
    batches = iter(loader)
    t0, data_time = time.perf_counter(), 0.0
    while state.step < max_iters:
        it = state.step
        if profile_at is not None and it == profile_at:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        t_wait = time.perf_counter()
        batch = next(batches)
        data_time += time.perf_counter() - t_wait
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        noise_gen.manual_seed(step_seed(tc.seed, it))
        dropout_gen.manual_seed(step_seed(tc.seed, it))
        use_gt = it < tc.use_gt_depth_until_iter          # UseGtDepthHook
        state, tstate, metrics = train_step(cfg, state, tstate, batch,
                                            noise_gen, dropout_gen,
                                            use_gt_depth=use_gt)
        if prof is not None and it == profile_at + 2:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(f'{work_dir}/trace.json')
            prof = None
        if (it + 1) % window == 0:
            m = {k: float(v) for k, v in metrics.items()}
            dt = (time.perf_counter() - t0) / window
            m.update(time=dt, data_time=data_time / window)
            t0, data_time = time.perf_counter(), 0.0
            log.info('iter %d/%d %.3fs/it total=%.4f grad=%.2f',
                     it + 1, max_iters, dt, m['total_loss'], m['grad_norm'])
            with open(f'{work_dir}/metrics.jsonl', 'a') as f:
                f.write(json.dumps({'iter': it + 1, **m}) + '\n')
        ckpt.save(it + 1, state)
        if eval_fn is not None and (it + 1) % tc.checkpoint_every == 0:
            eval_fn(state)
    if prof is not None:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(f'{work_dir}/trace.json')
    # the final state is always restorable, also off the save interval
    if ckpt.latest_step() != state.step and state.step > 0:
        ckpt.save(state.step, state, force=True)
    ckpt.close()
    return state
