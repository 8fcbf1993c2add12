"""Device ms a frame of the ops launched inside the program's
``model.backbone`` and ``model.neck`` labels: the uint8 normalization, the
int8 path's input quantization, the backbone and the FPN, without the time
the device waits on their host."""

from harness import stages


def read(ctx):
    return stages.busy_ms(ctx, stages.BACKBONE)
