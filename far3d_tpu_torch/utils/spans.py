"""Profiler labels of the port's stages.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
is on, and a shared do-nothing context otherwise: outside a profiler a label
costs the flag test (about 0.2 us of host time) instead of the few
microseconds a ``record_function`` takes even with no profiler to record
it. Every label of the package goes through here.

The labels are user annotations of the profiler's trace, on the clock of the
kernels launched inside them, so a reader of the trace can put each kernel,
and each gap in which the device waited on the host, down to the stage the
host was in:

- ``serve.step``, ``serve.decode``: a streaming inference step
  (``train/step.py:make_infer_step``, ``train/petr_step.py``) and its
  NMS-free decode; ``serve.replay``, a frame replayed from CUDA graphs, and
  ``serve.capture``, a frame key's warm-up and capture
  (``utils/graphs.py``);
- ``model.backbone`` (the uint8 normalization, the int8 path's input
  quantization and the backbone; inside the ViT of ``models/vit.py``,
  ``model.backbone.patch`` around the patch embedding and position and
  ``model.backbone.window`` or ``model.backbone.global`` around each block,
  which a frame replayed from CUDA graphs does not show), ``model.neck``,
  ``model.head2d`` (Far3D's YOLOX head and depth net), ``model.queries``
  (from the towers to the decoder: proposals, lifting, memory alignment,
  embeddings, the mask),
  ``model.decoder`` with a ``model.decoder.layer`` around each layer,
  ``model.branches`` (class and box branches, box decoding) and
  ``model.memory`` (the memory written for the next frame), in both families,
  in inference and in training;
- ``train.inputs``, ``train.forward``, ``train.loss_3d`` (which holds
  ``train.match``, the auction's CUDA-graph replays), ``train.loss_2d``,
  ``train.backward``, ``train.optimizer`` (which holds
  ``train.grad_all_reduce``): a training step.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that labels its block `name` in a running profiler's
    trace, and does nothing when no profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
