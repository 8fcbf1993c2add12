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
what an uninterrupted one draws. ``train_loop`` is the loop of both model
families: ``run_training`` drives Far3D through it, ``run_petr_training``
StreamPETR (``train/petr_step.py``; the GT-depth switch does not apply).

Data parallelism (``parallel/mesh.py``, after ``init_distributed``): every
rank runs this loop on its loader's lanes (``TrainLoader(rank=,
world_size=)``). Every rank resumes from the step rank 0 picks, and then
takes rank 0's whole train state (``utils/checkpoint.py``:
``broadcast_state_``); the noise generator is seeded alike on
every rank (the step keeps the rank's lanes of the global draw), the
dropout generator with the rank folded in, so that lanes on different ranks
draw different masks. Rank 0 writes ``metrics.jsonl``, the log, the trace
and the checkpoints (``utils/checkpoint.py``); ``eval_fn`` runs on every
rank, each streaming its shard.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

import torch

from ..config import Far3DConfig, TrainConfig
from ..entry import build_model, resolve_device
from ..parallel import mesh
from ..utils.checkpoint import CheckpointManager, broadcast_state_
from ..utils.convert import init_state_dict, load_reference_checkpoint
from .step import TrainState, create_train_state, train_step

log = logging.getLogger('far3d_tpu_torch.train')


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The generators' seed for step number `step` of a run seeded `seed`;
    `rank` (the dropout generator's) sets the bits above the seed's."""
    return rank << 48 | (seed + 1) << 32 | step


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
    Runs on the card unless `device` says otherwise; under data parallelism
    on each rank, with the rank's loader (see the module docstring)."""
    tc = cfg.train
    device = resolve_device(device)
    model = build_model(cfg, device, weights=init_state_dict(cfg, tc.seed))
    if load_from:
        missing, _ = model.load_state_dict(load_reference_checkpoint(load_from),
                                           strict=False)
        log.info('loaded %s (%d reference keys not found, kept init)',
                 load_from, len(missing))
    state, tstate = create_train_state(cfg, model, batch=batch_size)

    def step(state, tstate, batch, it, noise_gen, dropout_gen):
        use_gt = it < tc.use_gt_depth_until_iter          # UseGtDepthHook
        return train_step(cfg, state, tstate, batch, noise_gen, dropout_gen,
                          use_gt_depth=use_gt)

    return train_loop(state, tstate, step, tc, loader, work_dir, device,
                      resume, max_iters, profile_at, eval_fn)


def run_petr_training(cfg, train_cfg: TrainConfig, loader, work_dir: str,
                      batch_size: int, resume: bool = True,
                      max_iters: Optional[int] = None, eval_fn=None,
                      device=None) -> TrainState:
    """``run_training`` for StreamPETR (a ``StreamPETRConfig`` and its
    ``train_cfg``): the model starts from ``petr_init_state_dict`` seeded by
    ``train_cfg.seed``; each step is ``train/petr_step.py``'s; the loop,
    logs, checkpoints and resume are the same."""
    from ..entry import build_petr_model
    from ..utils.convert import petr_init_state_dict
    from .petr_step import create_petr_train_state, petr_train_step
    device = resolve_device(device)
    model = build_petr_model(cfg, device, weights=petr_init_state_dict(
        cfg, train_cfg.seed))
    state, tstate = create_petr_train_state(model, train_cfg, batch_size)

    def step(state, tstate, batch, it, noise_gen, dropout_gen):
        return petr_train_step(cfg, train_cfg, state, tstate, batch,
                               noise_gen, dropout_gen)

    return train_loop(state, tstate, step, train_cfg, loader, work_dir,
                      device, resume, max_iters, eval_fn=eval_fn)


def train_loop(state: TrainState, tstate, step_fn, tc: TrainConfig, loader,
               work_dir: str, device: torch.device, resume: bool = True,
               max_iters: Optional[int] = None,
               profile_at: Optional[int] = None, eval_fn=None) -> TrainState:
    """The loop of both families: ``step_fn(state, tstate, batch, it,
    noise_gen, dropout_gen) -> (state, tstate, metrics)`` until step
    `max_iters` (default ``tc.total_iters``), with the logs, saves, resume,
    evaluation and profiling that ``run_training`` describes."""
    max_iters = max_iters or tc.total_iters
    rank, _ = mesh.rank_and_world()
    main = mesh.is_main()
    ckpt = CheckpointManager(work_dir, max_to_keep=tc.keep_checkpoints,
                             save_interval=tc.checkpoint_every)
    if resume and ckpt.restore(state) is not None and main:
        log.info('resumed from step %d', state.step)
    # the ranks go on from rank 0's state (a loaded .pth, a resume included)
    broadcast_state_(state)

    noise_gen = torch.Generator()
    dropout_gen = torch.Generator(device=device)
    window = max(tc.log_every, 1)
    prof = None
    batches = iter(loader)
    t0, data_time = time.perf_counter(), 0.0
    while state.step < max_iters:
        it = state.step
        if main and profile_at is not None and it == profile_at:
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
        dropout_gen.manual_seed(step_seed(tc.seed, it, rank))
        state, tstate, metrics = step_fn(state, tstate, batch, it,
                                         noise_gen, dropout_gen)
        if prof is not None and it == profile_at + 2:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(f'{work_dir}/trace.json')
            prof = None
        if main and (it + 1) % window == 0:
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
