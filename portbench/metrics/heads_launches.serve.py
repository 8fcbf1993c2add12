"""Kernel launches a frame whose host launch falls inside one of the
program's heads labels (``model.head2d``, ``model.queries``,
``model.decoder``, ``model.branches``, ``model.memory``)."""

from harness import stages


def read(ctx):
    return stages.launches(ctx, stages.HEADS)
