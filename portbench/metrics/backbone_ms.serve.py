"""Device ms a frame from the detector's forward to its neck's: the
backbone (bf16 or int8, with the int8 path's input quantization), from
CUDA events on forward hooks the benchmark places."""


def read(ctx):
    ms = ctx.traced['spans_ms'].get('backbone')
    return None if ms is None else ms / ctx.traced['frames']
