"""Device ms a step of the ops launched inside the program's
``train.backward`` label (on any host thread)."""


def read(ctx):
    s = ctx.traced['trace'].under_label('train.backward')
    return None if s is None else s * 1e3 / ctx.traced['steps']
