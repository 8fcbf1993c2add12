"""MSDA forward's share of its roofline in the traced serving window: the
least time of every call (the bytes its operands need at 3.35 TB/s, or its
multiply-adds at 67 TFLOP/s f32, the larger; ``harness/work.py``), summed
over the calls a hook captured in the `trace_frames` frames just before
the profiled ones (as many frames of the same stream; counted frame by
frame, so that no operand outlives its frame), over the device time of
the op's kernels in the profiled frames (``kernels/msda_fwd/``). Nothing
to read where no MSDA kernel ran."""


def read(ctx):
    need = ctx.traced.get('msda_fwd')
    seconds, count = ctx.traced['trace'].kernel_seconds(ctx.kernels('msda_fwd'))
    if not need or not need['calls'] or not count:
        return None
    return 100.0 * need['bound_s'] / seconds
