"""The ViT backbone's attention: the least time of one frame's attention
calls at the chip's peaks, counted from the configuration's shapes, and the
device time of the attention kernels launched inside a label.

Per block, one attention call over every camera: a global block attends
each real query to its camera's grid, a windowed block each real query to
the ``window_size ** 2`` keys of its window (the padded keys are part of
ViTDet's equation). FLOP are ``4 x heads x queries x keys x head_dim`` (the
two matmuls); bytes are q, k, v and o of the real tokens in bf16 (a padded
key's k is zero and its v the bias, nothing to read). The least time of a
call is the larger of its FLOP at the bf16 peak and its bytes at the HBM
bandwidth (``work.py``)."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from . import work

BF16_BYTES = 2


def attention_calls(vit: Dict, num_cams: int, input_hw: Sequence[int]
                    ) -> List[Dict]:
    """One frame's attention calls in block order, each {block, kind,
    flops, bytes}, from the backbone's configuration (``ViTConfig`` as a
    dict) and the rig."""
    p = vit['patch_size']
    rows, cols = input_hw[0] // p, input_hw[1] // p
    tokens = num_cams * rows * cols
    heads, width = vit['num_heads'], vit['embed_dim']
    head_dim = width // heads
    ws = vit['window_size']
    calls = []
    for i in range(vit['depth']):
        if i in vit['global_blocks']:
            kind, keys = 'global', rows * cols
        else:
            kind, keys = 'window', ws * ws
        calls.append(dict(block=i, kind=kind,
                          flops=4 * heads * tokens * keys * head_dim,
                          bytes=4 * tokens * width * BF16_BYTES))
    return calls


def least_seconds(calls: List[Dict]) -> float:
    return sum(work.bound_seconds(c['bytes'], c['flops'],
                                  work.PEAKS['bf16_flops']) for c in calls)


def kernels_under(trace, names: Sequence[str], label: str
                  ) -> Optional[Tuple[float, int]]:
    """(device seconds, count) of the kernels whose name contains one of
    `names` and whose host launch falls inside `label` (a CUDA graph's
    kernels by their ``cudaGraphLaunch``); None where the label never
    ran."""
    spans = trace.labels.get(label)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total, count = 0, 0
    for s, e, name, _, corr in trace.kernels():
        if not any(n in name for n in names):
            continue
        at = trace.launch_at.get(corr)
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= spans[i][1]:
            total += e - s
            count += 1
    return total / 1e9, count

