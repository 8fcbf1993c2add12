"""The int8 conv's share of its roofline in the traced serving window:
per conv site of the configuration's backbone, the larger of its
operations at 1,979 TOP/s int8 and its bytes at 3.35 TB/s, summed over
the sites and the frames (``harness/work.py:qconv_sites``), over the device
time of the op's kernels (``kernels/qconv/``). Nothing to read where no
int8 conv kernel ran."""

from harness import work


def read(ctx):
    seconds, count = ctx.traced['trace'].kernel_seconds(ctx.kernels('qconv'))
    if not count:
        return None
    fam = ctx.family
    sites = work.qconv_sites(ctx.backbone, fam.num_cams, fam.input_hw)
    bound = work.qconv_bound_seconds(sites) * ctx.traced['frames']
    return 100.0 * bound / seconds
