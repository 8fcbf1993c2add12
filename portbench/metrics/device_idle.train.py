"""The device's idle share of a step: one minus the device's busy time a
step (the union of the intervals in which a kernel, a copy or a memset
ran in the traced window, ``harness/trace.py``, over the steps traced)
over the measured step_ms of the same run. The profiler's own host work
slows the traced steps (about twice as long), so the window's wall time
would count that as idle; the device's work is the same in both."""


def read(ctx):
    busy = ctx.traced['trace'].busy_s() / ctx.traced['steps']
    return 100.0 * (1.0 - busy / (ctx.e2e['step_ms'] / 1e3))
