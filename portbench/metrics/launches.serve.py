"""Kernel launches a frame in the traced window."""


def read(ctx):
    return ctx.traced['trace'].launches() / ctx.traced['frames']
