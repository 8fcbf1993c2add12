"""The ViT backbone's attention's share of its roofline in the traced
serving window: the least time of one frame's attention calls
(``harness/vit.py``: per block, the larger of its FLOP at 989 TFLOP/s bf16
and its q, k, v and o bytes at 3.35 TB/s), times the traced frames, over
the device time that ``vit_attn_ms.serve`` reads. Nothing where no such
kernel ran."""

from harness import vit


def read(ctx):
    found = vit.kernels_under(ctx.traced['trace'], ctx.kernels('vit_attn'),
                              'model.backbone')
    if not found or not found[1]:
        return None
    fam = ctx.family
    calls = vit.attention_calls(ctx.backbone, fam.num_cams, fam.input_hw)
    least = vit.least_seconds(calls) * ctx.traced['frames']
    return 100.0 * least / found[0]
