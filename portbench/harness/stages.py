"""What the stage metrics read from a traced window: the program's own
labels (``far3d_tpu_torch/utils/spans.py``), grouped by layer, and three
measures of a group on the profiler's one clock. A group lists top-level
labels only, so a kernel launched inside a nested label (a decoder layer
inside the decoder) counts once; the idle, which goes to the innermost
label open in a gap, adds the nested ones."""

from __future__ import annotations

import bisect
import sys
from typing import Optional, Sequence

BACKBONE = ('model.backbone', 'model.neck')
HEADS = ('model.head2d', 'model.queries', 'model.decoder', 'model.branches',
         'model.memory')
NESTED = {'model.decoder': ('model.decoder.layer',)}
# the benchmark's own labels, which a gap goes to only where no label of the
# program is open
BENCH = ('bench.window', 'bench.frame', 'bench.step')


def ran(trace, labels: Sequence[str]) -> bool:
    return any(trace.labels.get(name) for name in labels)


def busy_ms(ctx, labels: Sequence[str], per: str = 'frames'
            ) -> Optional[float]:
    """Device ms a frame (or step) of the ops launched inside `labels`;
    None where none of them ran (a program without the labels)."""
    t = ctx.traced['trace']
    parts = [t.under_label(name) for name in labels]
    if all(p is None for p in parts):
        return None
    return sum(p or 0.0 for p in parts) * 1e3 / ctx.traced[per]


def idle_ms(ctx, labels: Sequence[str], metric: str) -> Optional[float]:
    """The untraced frame's idle ms put down to `labels`: the share of the
    traced window's idle whose innermost label is one of `labels` or of
    their nested labels, times the idle of an untraced frame (frame_ms less
    the traced busy ms a frame, what ``device_idle.serve`` reads). The
    profiler roughly doubles the host's work, so the traced gaps themselves
    overstate the idle; they are printed to standard error."""
    t = ctx.traced['trace']
    if not ran(t, labels):
        return None
    group = set(labels) | {n for top in labels for n in NESTED.get(top, ())}
    gaps = t.idle_gaps(10 ** 6, skip=BENCH)
    total = sum(s for _, s in gaps)
    if total <= 0:
        return None
    frames = ctx.traced['frames']
    mine = sum(s for label, s in gaps if label in group)
    busy = t.busy_s() * 1e3 / frames
    print(f'{metric}: traced idle {mine * 1e3 / frames!r} ms a frame of '
          f'{total * 1e3 / frames!r} ms; untraced idle '
          f"{ctx.e2e['frame_ms'] - busy!r} ms a frame", file=sys.stderr)
    return mine / total * (ctx.e2e['frame_ms'] - busy)


def launches(ctx, labels: Sequence[str]) -> Optional[float]:
    """Kernel launches a frame whose host launch falls inside one of
    `labels`; None where none of them ran."""
    t = ctx.traced['trace']
    if not ran(t, labels):
        return None
    spans = [t.labels[name] for name in labels if t.labels.get(name)]
    starts = [[s for s, _ in sp] for sp in spans]
    count = 0
    for *_, corr in t.kernels():
        at = t.launch_at.get(corr)
        if at is None:
            continue
        for sp, st in zip(spans, starts):
            i = bisect.bisect_right(st, at) - 1
            if i >= 0 and at <= sp[i][1]:
                count += 1
                break
    return count / ctx.traced['frames']
