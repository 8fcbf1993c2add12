"""Device ms a frame of the ViT backbone's attention: the kernels named in
``kernels/vit_attn/`` whose host launch falls inside the program's
``model.backbone`` label (in a replayed frame, the towers graph's launch),
so the head's cross attention is left out. Nothing where no such kernel
ran there."""

from harness import vit


def read(ctx):
    found = vit.kernels_under(ctx.traced['trace'], ctx.kernels('vit_attn'),
                              'model.backbone')
    if not found or not found[1]:
        return None
    return found[0] * 1e3 / ctx.traced['frames']
