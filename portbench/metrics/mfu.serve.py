"""The frame's share of the chip's peak: the least time of one frame's
work at the published peaks (the int8 backbone's conv operations at 1,979
TOP/s, everything else at 989 TFLOP/s bf16; counted on the reference by
``harness/work.py``) over the measured frame_ms of the same run."""

from harness.work import PEAKS


def read(ctx):
    f = ctx.flops
    if not f:
        return None
    least = f['float_flops'] / PEAKS['bf16_flops'] \
        + f['int8_ops'] / PEAKS['int8_ops']
    return 100.0 * least / (ctx.e2e['frame_ms'] / 1e3)
