"""Device ms a frame of the ops launched inside the program's heads labels:
``model.head2d`` (Far3D's YOLOX head and depth net), ``model.queries``,
``model.decoder`` (its layers included), ``model.branches`` and
``model.memory``, without the time the device waits on their host."""

from harness import stages


def read(ctx):
    return stages.busy_ms(ctx, stages.HEADS)
