"""Idle ms a frame in which the device waits on the host inside the heads
labels (``model.head2d``, ``model.queries``, ``model.decoder`` and its
layers, ``model.branches``, ``model.memory``): their share of the traced
window's idle times an untraced frame's idle
(``harness/stages.py:idle_ms``)."""

from harness import stages


def read(ctx):
    return stages.idle_ms(ctx, stages.HEADS, 'heads_idle_ms.serve')
