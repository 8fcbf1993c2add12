"""The ViT backbone's rotation of q and k's share of its roofline in the
traced serving window: the least time of one frame's rotations
(``harness/rope.py``: their bytes at 3.35 TB/s), times the traced frames,
over the device time of the kernels named in ``kernels/vit_rope/`` whose
host launch falls inside the program's ``model.backbone`` label (in a
replayed frame, the towers graph's launch). Nothing where no such kernel
ran."""

from harness import rope, vit


def read(ctx):
    found = vit.kernels_under(ctx.traced['trace'], ctx.kernels('vit_rope'),
                              'model.backbone')
    if not found or not found[1]:
        return None
    fam = ctx.family
    least = rope.least_seconds(ctx.backbone, fam.num_cams, fam.input_hw)
    return 100.0 * least * ctx.traced['frames'] / found[0]
