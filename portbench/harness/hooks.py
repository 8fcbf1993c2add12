"""Hooks the benchmark places on the program's modules outside the measured
window (the pattern of ``tools/profile_torch_port.py:_stage_hooks``):

- ``Spans``: CUDA events recorded by forward pre-hooks and hooks, so a
  span's device time runs from the event before one module's forward to
  the event after another's.
- ``capture_msda``: a forward hook on every MSDA sampler that keeps its
  operands (value, loc, weights) for the bound computed after the
  window.
- ``Capture``: forward hooks, placed for one checked frame or step, that
  keep chosen modules' arguments and outputs, so the reference can take
  each stage from the program's own input to it.
- ``replaced_output``: a stage of the reference made to return the
  program's output of it."""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import Dict, List, Sequence

import torch


class Spans:
    """Named device spans, each from `start` module's pre-hook to `end`
    module's post-hook (or pre-hook with ``end_pre``)."""

    def __init__(self):
        self.events: Dict[str, List[List]] = collections.defaultdict(list)
        self.handles = []

    def add(self, name: str, start: torch.nn.Module, end: torch.nn.Module,
            end_pre: bool = False) -> None:
        def begin(m, a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[name].append([ev, None])

        def finish(m, *rest, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if self.events[name] and self.events[name][-1][1] is None:
                self.events[name][-1][1] = ev

        self.handles.append(start.register_forward_pre_hook(begin))
        if end_pre:
            self.handles.append(end.register_forward_pre_hook(finish))
        else:
            self.handles.append(end.register_forward_hook(finish))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []

    def ms_each(self) -> Dict[str, float]:
        """Summed ms of each span over the window (call after a
        synchronize)."""
        return {name: sum(s.elapsed_time(e) for s, e in pairs
                          if e is not None)
                for name, pairs in self.events.items()}


def msda_modules(model: torch.nn.Module) -> List[torch.nn.Module]:
    """The model's MSDA samplers (modules of a class named ``MSDA``)."""
    return [m for m in model.modules() if type(m).__name__ == 'MSDA']


def capture_msda(modules: Sequence[torch.nn.Module], keep: List,
                 limit: int) -> list:
    """Forward hooks that append (spatial_shapes, value, loc, weights) of
    up to `limit` calls to `keep`; returns the handles."""
    def hook(m, args, out):
        if len(keep) < limit:
            value, loc, weights = args
            keep.append((m.spatial_shapes, value.detach(), loc.detach(),
                         weights.detach()))
    return [m.register_forward_hook(hook) for m in modules]


def first_backward_operands(module: torch.nn.Module, keep: Dict):
    """A forward hook on one MSDA sampler that keeps the operands of its
    first call that needs a gradient."""
    def hook(m, args, out):
        if 'args' in keep or not out.requires_grad:
            return
        value, loc, weights = args
        keep['args'] = (m.spatial_shapes, value.detach().clone(),
                        loc.detach().clone(), weights.detach().clone())
    return module.register_forward_hook(hook)


class Capture:
    """While open (a ``with`` block), keeps each of `modules`' ({name:
    module}) output of its last call, and its positional arguments where
    the name is in `args_for` (all where it is None): ``taken`` is {name:
    [args or None, output]}. The driver opens one around each checked
    frame alone, so no hook sits on the program in the other frames."""

    def __init__(self, modules: Dict[object, torch.nn.Module],
                 args_for=None):
        self.modules = modules
        self.args_for = args_for
        self.taken: Dict[object, list] = {}
        self.handles = []

    def __enter__(self):
        for name, m in self.modules.items():
            self.handles.append(m.register_forward_pre_hook(
                functools.partial(self._pre, name)))
            self.handles.append(m.register_forward_hook(
                functools.partial(self._post, name)))
        return self

    def _pre(self, name, m, args):
        keep = self.args_for is None or name in self.args_for
        self.taken[name] = [args if keep else None, None]

    def _post(self, name, m, args, out):
        self.taken[name][1] = out

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []

    def out(self, name):
        return self.taken[name][1]


@contextlib.contextmanager
def replaced_output(module: torch.nn.Module, out):
    """`module`'s calls return `out` in the block (a forward hook's
    replacement): the reference takes the program's output of a stage."""
    handle = module.register_forward_hook(lambda m, args, res: out)
    try:
        yield
    finally:
        handle.remove()
