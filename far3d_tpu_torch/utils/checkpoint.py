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
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

import torch

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
        if not force and not self.should_save(step):
            return False
        if step in self.all_steps():
            raise FileExistsError(f'checkpoint for step {step} already exists '
                                  f'in {self.directory}')
        path = self.directory / f'{step}.pt'
        tmp = self.directory / f'.{step}.pt.tmp'
        torch.save({'step': step,
                    'model': state.model.state_dict(),
                    'optimizer': state.optimizer.state_dict(),
                    'ema': state.ema}, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            (self.directory / f'{old}.pt').unlink()
        return True

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """Load step `step` (default: the latest) into `state`, in place, and
        return it; None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
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
