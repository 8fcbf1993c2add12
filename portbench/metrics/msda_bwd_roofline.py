"""The MSDA backward's share of its roofline in the traced training
window: the least time of one call on decoder layer 0's operands (the
bytes the value gradient and the location / weight gradient need at 3.35
TB/s, or their multiply-adds at 67 TFLOP/s f32, the larger;
``harness/work.py``) times the backward's calls (the sampler's forward
calls that need a gradient), over the device time of the op's kernels
(``kernels/msda_bwd/``), the library sort it launches between two of them
included."""

import sys

from harness import work


def read(ctx):
    one = ctx.traced.get('msda_bwd_one_call')
    t = ctx.traced['trace']
    seconds, _ = t.kernel_seconds(ctx.kernels('msda_bwd'))
    between = [t.seconds_between(a, b)
               for a, b in ctx.brackets('msda_bwd')]
    calls = ctx.traced.get('msda_bwd_calls')
    if not one or not calls or not seconds:
        return None
    sort_s = sum(s for s, _ in between)
    print(f'msda_bwd: own kernels {seconds!r} s, between them '
          f'{sort_s!r} s in {sum(n for _, n in between)} kernels',
          file=sys.stderr)
    bound = work.bound_seconds(one['bytes'], one['flops'],
                               work.PEAKS['f32_flops'])
    return 100.0 * bound * calls / (seconds + sort_s)
