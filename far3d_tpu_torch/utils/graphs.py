"""Streaming frames replayed from CUDA graphs.

``GraphedStep(frame)`` is a streaming step, ``step(model, tstate, batch,
quant_tree=None) -> (detections, tstate)``, that a family's infer step
(``train/step.py:make_infer_step``,
``train/petr_step.py:make_petr_infer_step``) builds from its frame function
``frame(model, tstate, batch, quant_tree, feats=None)``: the model's call
and the decode. Given `feats`, the output of
``model.forward_towers(batch['images'], quant_tree)`` (normalization, the
int8 path's input quantization, the backbone, the FPN), the model starts
from them.

A frame whose model, quantized tree, device and tensor shapes and dtypes
(``frame_key``) the step has run before is replayed from two CUDA graphs:
the towers' inside the ``model.backbone`` label and the rest of the frame's
(``frame`` from `feats`) inside ``model.queries``, both inside
``serve.replay``, so a profiler puts each graph's kernels where their ops'
labels put them in an eager frame. The first frame of a key runs eagerly;
the second warms the key up on a side stream and captures both graphs into
one memory pool, inside the ``serve.capture`` label, then replays them.

A frame runs eagerly (``step.eager``: ``frame`` inside ``serve.step``) on
the CPU, while any forward hook or pre-hook is registered on a module of
the model or globally, and while any module's ``capture`` list is set
(``models/decoder.py:capture_sampling``): a replay calls no module, so it
cannot honour a caller asking to see module calls.

A replay copies the caller's batch and state into the key's static input
tensors and returns clones of the static outputs: nothing a step returns is
written by a later frame, and a state from an eager frame may feed a
replayed one and the reverse. ``captures``, ``replays`` and
``eager_frames`` count the step's frames by kind. A replay calls no
launch-counting wrapper (``ops/_build.py:launch_counts``); the warm-up and
the capture do, and ``capture_launches`` keeps, by key, what the capture's
wrappers counted: the port-kernel launches each replay makes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..ops import _build
from .spans import span


def _fields(tstate) -> list:
    return [(f.name, getattr(tstate, f.name))
            for f in dataclasses.fields(tstate)]


def frame_key(model, tstate, batch: Dict[str, torch.Tensor],
              quant_tree=None) -> tuple:
    """What a captured frame is good for: the model and the quantized tree
    (by identity), and the name, device, dtype and shape of every batch and
    state tensor."""
    tensors = sorted(batch.items()) + _fields(tstate)
    return (id(model), id(quant_tree),
            tuple((name, t.device, t.dtype, tuple(t.shape))
                  for name, t in tensors))


def _graphable(key: tuple) -> bool:
    """Whether a frame of `key` can be captured: every tensor on one card."""
    devices = {device for _, device, _, _ in key[2]}
    return len(devices) == 1 and devices.pop().type == 'cuda'


class _Watch:
    """A model's modules, for the test that something is watching its
    calls."""

    def __init__(self, model: torch.nn.Module):
        self.modules = list(model.modules())
        self.capturing = [m for m in self.modules if 'capture' in vars(m)]

    def observed(self) -> bool:
        """True while a forward hook or pre-hook is registered globally or
        on one of the modules, or a module's ``capture`` list is set."""
        glob = torch.nn.modules.module
        if glob._global_forward_hooks or glob._global_forward_pre_hooks:
            return True
        return (any(m._forward_hooks or m._forward_pre_hooks
                    for m in self.modules)
                or any(m.capture is not None for m in self.capturing))


def _clone(tree):
    """A copy of a tensor, or of a dict, list, tuple or dataclass of
    tensors, in new memory."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return type(tree)(**{k: _clone(v) for k, v in _fields(tree)})


def _copy(dst, src) -> None:
    """Copies `src`'s tensors into `dst`'s, tree for tree as ``_clone``."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            _copy(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy(d, s)
    else:
        for k, v in _fields(dst):
            _copy(v, getattr(src, k))


class _Capture:
    """Capture on one card: a side stream for the warm-up and the
    captures, and one memory pool that a key's graphs share."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm_up(self, fn: Callable[[], Any]) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def __call__(self, fn: Callable[[], Any]) -> Tuple[Callable[[], None],
                                                       Any]:
        """(the graph's replay, fn's outputs as captured: the tensors each
        replay writes)."""
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (a loader's workers pinning the next
        # batches) keep calling CUDA while a frame is captured
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode='thread_local'):
            out = fn()
        return graph.replay, out


class _Frame:
    """One key's two graphs over its static inputs and outputs."""

    def __init__(self, step: 'GraphedStep', model, tstate, batch,
                 quant_tree, device: torch.device):
        self.pinned = (model, quant_tree)   # the graphs read their tensors
        self.batch, self.state = _clone(batch), _clone(tstate)
        capture = _Capture(device)

        def towers():
            return model.forward_towers(self.batch['images'], quant_tree)

        def rest(feats):
            return step.frame(model, self.state, self.batch, quant_tree,
                              feats)

        with span('serve.capture'):
            capture.warm_up(lambda: rest(towers()))
            before = dict(_build.launch_counts)
            self.replay_towers, self.feats = capture(towers)
            self.replay_rest, self.out = capture(lambda: rest(self.feats))
        self.launches = {name: n - before.get(name, 0) for name, n in
                         _build.launch_counts.items()
                         if n != before.get(name, 0)}

    def run(self, tstate, batch):
        _copy(self.batch, batch)
        _copy(self.state, tstate)
        with span('serve.replay'):
            with span('model.backbone'):
                self.replay_towers()
            with span('model.queries'):
                self.replay_rest()
        return _clone(self.out)


class GraphedStep:
    """A streaming step run from CUDA graphs once it has seen a frame's
    key (see the module's docstring)."""

    def __init__(self, frame: Callable):
        self.frame = frame
        # key -> (model, quant_tree), held so that the ids in a key stay theirs
        self._seen: Dict[tuple, tuple] = {}
        self._frames: Dict[tuple, _Frame] = {}
        self._watch: Dict[int, _Watch] = {}
        self.captures = self.replays = self.eager_frames = 0
        self.capture_launches: Dict[tuple, Dict[str, int]] = {}

    @torch.inference_mode()
    def eager(self, model, tstate, batch: Dict[str, torch.Tensor],
              quant_tree=None):
        """The frame op by op, as every frame ran before CUDA graphs."""
        with span('serve.step'):
            return self.frame(model, tstate, batch, quant_tree)

    @torch.inference_mode()
    def __call__(self, model, tstate, batch: Dict[str, torch.Tensor],
                 quant_tree=None):
        key = frame_key(model, tstate, batch, quant_tree)
        watch = self._watch.get(id(model))
        if watch is None:
            watch = self._watch[id(model)] = _Watch(model)
        frame: Optional[_Frame] = self._frames.get(key)
        if (not _graphable(key) or watch.observed()
                or (frame is None and key not in self._seen)):
            self._seen.setdefault(key, (model, quant_tree))
            self.eager_frames += 1
            return self.eager(model, tstate, batch, quant_tree)
        with span('serve.step'):
            if frame is None:
                frame = self._frames[key] = _Frame(
                    self, model, tstate, batch, quant_tree, key[2][0][1])
                self.captures += 1
                self.capture_launches[key] = frame.launches
            self.replays += 1
            return frame.run(tstate, batch)
