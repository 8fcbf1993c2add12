"""The device's idle share of a frame: one minus the device's busy time a
frame (the union of the intervals in which a kernel, a copy or a memset
ran in the traced window, ``harness/trace.py``, over the frames traced)
over the measured frame_ms of the same run. The profiler's own host work
slows the traced frames (about twice as long), so the window's wall time
would count that as idle; the device's work is the same in both."""


def read(ctx):
    busy = ctx.traced['trace'].busy_s() / ctx.traced['frames']
    return 100.0 * (1.0 - busy / (ctx.e2e['frame_ms'] / 1e3))
