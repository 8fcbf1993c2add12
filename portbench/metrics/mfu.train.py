"""The step's share of the chip's peak: three times one training
forward's FLOP (the forward, and twice that for the backward; counted on
the reference by ``harness/work.py``) at 989 TFLOP/s bf16, over the
measured step_ms of the same run."""

from harness.work import PEAKS


def read(ctx):
    f = ctx.flops
    if not f:
        return None
    least = 3 * f['float_flops'] / PEAKS['bf16_flops']
    return 100.0 * least / (ctx.e2e['step_ms'] / 1e3)
