"""The share, in %, of the traced frames that the program replayed from
CUDA graphs: 100 x its ``serve.replay`` labels (one a replayed frame,
``far3d_tpu_torch/utils/graphs.py``) over the traced frames. Nothing where
the label never ran (a program that runs every frame op by op)."""


def read(ctx):
    replays = ctx.traced['trace'].labels.get('serve.replay')
    if not replays:
        return None
    return 100.0 * len(replays) / ctx.traced['frames']
