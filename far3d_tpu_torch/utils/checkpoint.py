"""Checkpointing of the train state (counterpart of
``far3d_tpu/utils/checkpoint.py``; reference mmcv CheckpointHook +
resume_from, core/apis/mmdet_train.py:199-203, far3d.py:280).

One file per step, ``<directory>/<step>.pt``, holding the whole train state
through ``torch.save``: the model's ``state_dict`` (parameters and buffers,
the YOLOX BN statistics among them), the AdamW state (both moments and their
step counts), the EMA shadow and the step. It is written to a temporary file
and renamed, so a file with a step's name is always whole. The temporal
memory is not saved, as in the reference, whose memory queue restarts cold
on resume (farhead.py:446-451).

Which steps are written and kept follows the orbax ``CheckpointManager`` that
the JAX package uses: ``save`` writes when the step is past the latest one
and is a multiple of ``save_interval``, or when no checkpoint exists yet;
``force`` writes any step not already on disk; after a write only the
``max_to_keep`` highest steps stay.

Under data parallelism (``parallel/mesh.py``) rank 0 decides and writes, its
decision broadcast so that every rank agrees on it (and raises together when
the step is already on disk); a barrier follows each write, so that no rank
goes on (or resumes) before the file is whole. Every rank restores the step
that rank 0 picks, which needs a file system all ranks share: when a rank
cannot see that file, every rank raises. ``broadcast_state_`` then gives
every rank rank 0's whole train state, so that what a rank's own load found
is not taken on trust.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

import torch

from ..parallel import mesh
from ..train.step import TrainState

_NAME = re.compile(r'^(\d+)\.pt$')


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 1,
                 save_interval: int = 1):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return False
        return not steps or step % self.save_interval == 0

    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        """Write `state` as step `step` when the policy above says so (or
        `force`); returns whether it wrote."""
        rank, world = mesh.rank_and_world()
        # rank 0 decides: 0 skip, 1 write, 2 the step is already on disk
        decision = 0
        if rank == 0 and (force or self.should_save(step)):
            decision = 2 if step in self.all_steps() else 1
        if world > 1:
            flag = torch.tensor([decision])
            mesh.broadcast_([flag])
            decision = int(flag.item())
        if decision == 2:
            raise FileExistsError(f'checkpoint for step {step} already exists '
                                  f'in {self.directory}')
        if decision == 0:
            return False
        if rank == 0:
            path = self.directory / f'{step}.pt'
            tmp = self.directory / f'.{step}.pt.tmp'
            torch.save({'step': step,
                        'model': state.model.state_dict(),
                        'optimizer': state.optimizer.state_dict(),
                        'ema': state.ema}, tmp)
            os.replace(tmp, path)
            for old in self.all_steps()[:-self.max_to_keep]:
                (self.directory / f'{old}.pt').unlink()
        mesh.barrier()
        return True

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """Load step `step` (default: the latest) into `state`, in place, and
        return it; None when there is no checkpoint. Under data parallelism
        the step is rank 0's, and every rank raises FileNotFoundError when
        one of them cannot see its file."""
        step = self.latest_step() if step is None else step
        rank, world = mesh.rank_and_world()
        if world > 1:
            pick = torch.tensor([-1 if step is None else step])
            mesh.broadcast_([pick])
            step = None if pick.item() < 0 else int(pick.item())
            if step is not None:
                missing = torch.tensor(
                    [int(not (self.directory / f'{step}.pt').is_file())])
                mesh.all_reduce_sum_(missing)
                if missing.item():
                    raise FileNotFoundError(
                        f'{missing.item()} of {world} ranks cannot see step '
                        f'{step} in {self.directory}, which rank 0 resumes '
                        'from: the ranks need a checkpoint directory they '
                        'share')
        if step is None:
            return None
        ckpt = torch.load(self.directory / f'{step}.pt', map_location='cpu',
                          weights_only=True)
        state.model.load_state_dict(ckpt['model'])
        state.optimizer.load_state_dict(ckpt['optimizer'])
        if (ckpt['ema'] is None) != (state.ema is None):
            raise ValueError(f'step {step}: the checkpoint has '
                             f'{"no " if ckpt["ema"] is None else ""}EMA '
                             'and the state '
                             f'{"does not" if state.ema is None else "does"}')
        if state.ema is not None:
            for k, v in ckpt['ema'].items():
                state.ema[k].copy_(v)
        state.step = int(ckpt['step'])
        return state

    def close(self):
        """Nothing stays open between calls; kept for the JAX package's
        interface."""


def broadcast_state_(state: TrainState) -> int:
    """Give every rank rank 0's train state, in place: parameters and
    buffers, the EMA shadow, the AdamW moments and step counts, and the
    step. The ranks then start equal whatever each one's own load found (a
    ``.pth``, a checkpoint). Every rank raises when the ranks' optimizer
    states differ in layout (one rank resumed and another did not). Returns
    the bytes sent; 0 without a group."""
    if mesh.group() is None:
        return 0
    opt = state.optimizer
    moments = [st[k] for g in opt.param_groups for p in g['params']
               for st in [opt.state.get(p, {})] for k in sorted(st)
               if torch.is_tensor(st[k])]
    # one bucket run per device and dtype (the step counts sit on the host)
    moments.sort(key=lambda t: (str(t.device), str(t.dtype)))
    layout = torch.tensor([len(moments), sum(t.numel() for t in moments)])
    first = layout.clone()
    mesh.broadcast_([first])
    differ = torch.tensor([int(not torch.equal(layout, first))])
    mesh.all_reduce_sum_(differ)
    if differ.item():
        raise ValueError(f'{differ.item()} ranks hold optimizer states of '
                         "another layout than rank 0's (tensors, elements: "
                         f'{first.tolist()})')
    step = torch.tensor([state.step])
    sent = mesh.broadcast_([step])
    state.step = int(step.item())
    sent += mesh.broadcast_module_(state.model)
    if state.ema is not None:
        sent += mesh.broadcast_(list(state.ema.values()))
    return sent + mesh.broadcast_(moments)
