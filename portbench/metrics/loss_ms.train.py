"""Device ms a step of the ops launched inside the program's
``train.loss_3d`` and ``train.loss_2d`` labels: the set losses with the
matching's auction (whose CUDA-graph replays are launched inside the
label), the YOLOX and depth losses."""


def read(ctx):
    t = ctx.traced['trace']
    parts = [t.under_label('train.loss_3d'), t.under_label('train.loss_2d')]
    if all(p is None for p in parts):
        return None
    return sum(p or 0.0 for p in parts) * 1e3 / ctx.traced['steps']
