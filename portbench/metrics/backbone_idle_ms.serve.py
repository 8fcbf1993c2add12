"""Idle ms a frame in which the device waits on the host inside
``model.backbone`` or ``model.neck``: their share of the traced window's
idle (a gap goes to the innermost label open at its middle) times an
untraced frame's idle (``harness/stages.py:idle_ms``)."""

from harness import stages


def read(ctx):
    return stages.idle_ms(ctx, stages.BACKBONE, 'backbone_idle_ms.serve')
