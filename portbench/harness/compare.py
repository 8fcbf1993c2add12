"""The comparisons that decide ``correct``: the numbers a cell's
``limits/<cell>.json`` names.

Serving, for each checked frame, each stage of the reference taking the
frame's inputs, the temporal state the program carried into it, or the
program's own output of the stage before:

- ``neck_rel``: the backbone and the FPN from the frame's images, the
  worst level;
- ``head2d_rel`` (Far3D): the YOLOX 2D head and the depth net on the
  program's FPN output, in float32, the worst map;
- ``head_in_rel``: every input of the decoder, computed by the reference
  from the program's FPN (and 2D head) output and the state carried in:
  the memory aligned to the current ego frame, the lifted 2D proposals,
  the queries, their positional encodings and the attention mask;
- ``decoder_step_rel``: each decoder layer on the program's own input to
  it, in float32;
- ``branch_rel``: the class and box branches on the program's decoder
  output;
- ``decode_wrong``, ``memory_wrong``: the decode of the program's outputs
  and the memory it writes for the next frame, compared exactly.

Each is the worst over the checked frames.

Training: each of the first steps' total loss, the first step's gradient
as the optimizer got it (AdamW's first moment after one step) and every
parameter's change after the steps, by leaf: the gap between the two
norms, over the larger of the reference leaf's norm and the median
leaf's (``leaf_gaps``)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

STATE_FIELDS = ('embedding', 'ref_points', 'timestamp', 'egopose', 'velo')


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def tensors(x) -> List[torch.Tensor]:
    """The tensors of a stage's output or arguments, in order (nested lists,
    tuples and dicts walked; anything else left out)."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors(v)]
    return []


def worst_rel(prog, ref) -> float:
    """The worst relative L2 gap over matching tensors: a floating one by
    its norm, any other (masks, indices) by the share of its elements that
    differ."""
    p, r = tensors(prog), tensors(ref)
    if len(p) != len(r) or not p:
        return math.inf
    worst = 0.0
    for a, b in zip(p, r):
        if a.shape != b.shape:
            return math.inf
        if b.is_floating_point():
            worst = max(worst, _rel(a, b.to(a.device)))
        else:
            worst = max(worst, float((a != b.to(a.device)).double().mean()))
    return worst


def _f32(x):
    if torch.is_tensor(x) and x.is_floating_point():
        return x.float()
    return x


@torch.inference_mode()
def layer_steps(prog: Dict[int, list], ref_layers) -> List[float]:
    """Each decoder layer of the reference taken from the program's own
    input to that layer (cast to float32): the relative L2 gap of the
    program's output to the reference's, layer by layer."""
    return [_rel(out, ref_layers[i](*[_f32(a) for a in args]))
            for i, (args, out) in sorted(prog.items())]


def decode_wrong(dets: Dict[str, torch.Tensor], head: Dict, decode) -> float:
    """Elements of the served detections that differ from the reference's
    decode of the program's last-layer outputs."""
    ref = decode(head['all_cls_scores'][-1], head['all_bbox_preds'][-1],
                 head['query_valid'])
    return float(sum(int((ref[k].cpu() != dets[k]).sum()) for k in dets))


def memory_wrong(prog_state, ref_state) -> float:
    """The largest difference between the memory the program wrote and the
    reference's (every slot's embedding, reference point, timestamp, ego
    pose and velocity)."""
    return max(float((getattr(prog_state, k).double()
                      - getattr(ref_state, k).double()).abs().max())
               for k in STATE_FIELDS)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip: Sequence[str] = (), q: float = 1.0) -> float:
    """The gap between two norms of each leaf, over the larger of the
    reference leaf's norm and the median reference leaf's norm; the worst
    leaf's (`q` = 1) or another quantile over the leaves. Leaves in `skip`
    are left out."""
    keys = [k for k in ref if k not in skip]
    med = float(np.median([ref[k] for k in keys]))
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]
    return float(np.quantile(gaps, q))


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> (bool, List[List]):
    """correct when every compared number lies within its limit (a number
    that is not finite fails). Returns (correct, [[name, number, limit]])."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, float('nan'))
        good = math.isfinite(value) and value <= limit
        ok &= good
        rows.append([name, value, limit])
    return ok, rows
