"""Device ms a frame of the heads: Far3D's 2D head through the end of
FarHead (proposals, lifting, memory, decoder), StreamPETR's head; CUDA
events on forward hooks the benchmark places."""


def read(ctx):
    ms = ctx.traced['spans_ms'].get('head')
    return None if ms is None else ms / ctx.traced['frames']
