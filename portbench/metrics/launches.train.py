"""Kernel launches a step in the traced window."""


def read(ctx):
    return ctx.traced['trace'].launches() / ctx.traced['steps']
