"""Hungarian matching for the set losses (counterpart of
``far3d_tpu/train/matching.py``).

The reference runs scipy's ``linear_sum_assignment`` on the host per sample
per decoder layer (hungarian_assigner_3d.py:73-82). The JAX package matches
on the device with a single-phase Jacobi auction (``auction_match``,
matching.py:57-143), and so does the port: ``auction_match`` is that
auction step for step in torch ops, on the cost's device, and
``hungarian_match`` runs every cost of a training step as one padded batch
of problems. Two results are equal wherever the JAX package's are: every
operation of an iteration is exact (a subtraction, an addition, maxima and
first maximal indices), so the card, the CPU and the JAX package agree
bitwise on the same costs.

The loop has no host synchronization per iteration: it tests convergence
every ``CHECK_EVERY`` iterations, and on a card it replays those iterations
from one CUDA graph (``_Graph``), faster than the same chunks launched op by
op on both families' problems (``chip_smoke.py`` phase 20a times the two).
A converged problem is a fixed point of an iteration (no column bids, so
nothing changes), so the extra iterations change nothing and the result is
the JAX loop's, which stops at the first converged iteration or at
``max_iters``; the last chunk before the cap is cut to end at the cap.

``lsa_host`` (scipy's exact solver) is the oracle of the tests.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.spans import span

BIG_COST = 1e4
NEG_INF = -1e18
CHECK_EVERY = 8     # iterations between two convergence tests (host syncs)

# the solver's counts since the last reset: problems solved, auction
# iterations (those in which some column still bid, the JAX loop's count)
# and solver calls that ended in the greedy completion
STATS = dict(problems=0, iterations=0, greedy=0)


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def lsa_host(cost: np.ndarray) -> np.ndarray:
    """Batched scipy Hungarian (matching.py:31-44): cost (..., R, C) with
    R >= C -> matched row per column (..., C) int64."""
    from scipy.optimize import linear_sum_assignment
    cost = np.nan_to_num(np.asarray(cost, np.float32), nan=100.0,
                         posinf=100.0, neginf=-100.0)
    batch_shape = cost.shape[:-2]
    r, c = cost.shape[-2:]
    flat = cost.reshape(-1, r, c)
    out = np.zeros((flat.shape[0], c), np.int64)
    for i in range(flat.shape[0]):
        rows, cols = linear_sum_assignment(flat[i])
        out[i, cols] = rows
    return out.reshape(*batch_shape, c)


def _problems(cost: torch.Tensor, col_valid: Optional[torch.Tensor],
              eps_frac: float) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """cost (..., R, C) -> (benefit (n, C, R), col_valid (n, C), eps (n,)):
    each problem's eps from the max and min of its benefit with the invalid
    columns read as 0 (matching.py:78-81)."""
    r, c = cost.shape[-2:]
    benefit = -cost.detach().float().reshape(-1, r, c).transpose(1, 2)
    if col_valid is None:
        valid = torch.ones(benefit.shape[:2], dtype=torch.bool,
                           device=cost.device)
    else:
        valid = col_valid.to(cost.device).bool().reshape(-1, c)
    finite = torch.where(valid[..., None], benefit,
                         torch.zeros((), device=cost.device))
    scale = torch.maximum(finite.amax(dim=(1, 2)) - finite.amin(dim=(1, 2)),
                          torch.tensor(1e-6, device=cost.device))
    eps = scale * torch.tensor(eps_frac, dtype=torch.float32,
                               device=cost.device)
    return benefit, valid, eps


def _iterate(benefit: torch.Tensor, col_valid: torch.Tensor,
             eps: torch.Tensor, price: torch.Tensor, owner: torch.Tensor,
             assign: torch.Tensor, iters: torch.Tensor, n: int) -> None:
    """`n` Jacobi auction iterations (matching.py:88-115) over a batch of
    problems, in place on the state: price (N, R) f32, owner (N, R) (the
    column that holds a row, -1), assign (N, C) (the row a column holds, -1
    while it bids, -2 for an invalid column) and iters (), which counts the
    iterations in which some column bid.

    Padded rows (benefit -inf) are never any column's best or second-best
    row, so they never receive a bid. A bid is finite, or the problem's eps
    where it is not (matching.py:97); that eps is NaN only when the
    problem's costs hold a NaN, and then every bid of the problem is NaN
    and wins nothing, as JAX's NaN maximum wins nothing."""
    nb, c, r = benefit.shape
    dev = benefit.device
    rows = torch.arange(r, device=dev).expand(nb, r)
    cols = torch.arange(c, device=dev).expand(nb, c)
    eps = eps[:, None]
    for _ in range(n):
        active = assign == -1                              # (N, C)
        iters += active.any()
        value = benefit - price[:, None, :]                # (N, C, R)
        v1, j1 = value.max(dim=2)                          # first maximal row
        v2 = value.scatter(2, j1[..., None], NEG_INF).amax(dim=2)
        bid = v1 - torch.clamp_min(v2, NEG_INF / 2) + eps
        bid = torch.where(torch.isfinite(bid), bid, eps)
        bidding = active & ~torch.isnan(bid)
        # per row: the highest bid and the first column that made it; the
        # extra row r takes the columns that do not bid
        target = torch.where(bidding, j1, r)
        win_bid = torch.full((nb, r + 1), NEG_INF, device=dev).scatter_reduce(
            1, target, bid, 'amax')
        top = bidding & (bid == win_bid.gather(1, target))
        winner = torch.full((nb, r + 1), c, device=dev).scatter_reduce(
            1, torch.where(top, j1, r), cols, 'amin')
        win_bid, winner = win_bid[:, :r], winner[:, :r]
        won = win_bid > NEG_INF / 2
        price.copy_(torch.where(won, price + win_bid, price))
        owner.copy_(torch.where(won, winner, owner))
        # the assignment from the ownership: each column's first held row
        first = torch.full((nb, c + 1), r, device=dev).scatter_reduce(
            1, torch.where(owner >= 0, owner, c), rows, 'amin')[:, :c]
        assign.copy_(torch.where(col_valid, torch.where(first < r, first, -1),
                                 -2))


def _greedy(benefit: torch.Tensor, owner: torch.Tensor,
            assign: torch.Tensor) -> None:
    """matching.py:121-132: each column still without a row at the cap, in
    column order, takes its best free row."""
    for i in range(benefit.shape[1]):
        todo = assign[:, i] == -1
        val = torch.where(owner < 0, benefit[:, i], NEG_INF)
        j = val.argmax(dim=1)
        assign[:, i] = torch.where(todo, j, assign[:, i])
        held = owner.gather(1, j[:, None])[:, 0]
        owner.scatter_(1, j[:, None], torch.where(todo, i, held)[:, None])


class _Graph:
    """One CHECK_EVERY-iteration chunk of the auction for one problem shape
    on one card, captured once into a CUDA graph over static buffers (the
    inputs, copied in at each call, and the state)."""

    def __init__(self, shape, device):
        nb, c, r = shape
        self.benefit = torch.zeros(shape, device=device)
        self.valid = torch.zeros(nb, c, dtype=torch.bool, device=device)
        self.eps = torch.zeros(nb, device=device)
        self.price = torch.zeros(nb, r, device=device)
        self.owner = torch.full((nb, r), -1, dtype=torch.long, device=device)
        self.assign = torch.full((nb, c), -2, dtype=torch.long, device=device)
        self.iters = torch.zeros((), dtype=torch.long, device=device)
        state = (self.benefit, self.valid, self.eps, self.price, self.owner,
                 self.assign, self.iters)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):       # warm-up outside the capture
            _iterate(*state, 1)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            _iterate(*state, CHECK_EVERY)


_GRAPHS: Dict[tuple, _Graph] = {}


@torch.no_grad()
def _solve(benefit: torch.Tensor, col_valid: torch.Tensor, eps: torch.Tensor,
           max_iters: int) -> torch.Tensor:
    """The auction over a batch of problems -> (N, C) int64 row per column
    (0 for an invalid column, matching.py:133). On a card each
    CHECK_EVERY-iteration chunk is replayed from a CUDA graph, captured at
    the first call for the shape (one launch a chunk instead of about 20 a
    iteration); on the CPU the chunk runs eagerly."""
    nb, c, r = benefit.shape
    dev = benefit.device
    if dev.type == 'cuda':
        key = (tuple(benefit.shape), dev.index)
        if key not in _GRAPHS:
            _GRAPHS[key] = _Graph(benefit.shape, dev)
        g = _GRAPHS[key]
        g.benefit.copy_(benefit)
        g.valid.copy_(col_valid)
        g.eps.copy_(eps)
        benefit, col_valid, eps = g.benefit, g.valid, g.eps
        price, owner, assign, iters = g.price, g.owner, g.assign, g.iters
        price.zero_()
        owner.fill_(-1)
        iters.zero_()
        chunk = g.graph.replay
    else:
        price = torch.zeros(nb, r, device=dev)
        owner = torch.full((nb, r), -1, dtype=torch.long, device=dev)
        assign = torch.empty(nb, c, dtype=torch.long, device=dev)
        iters = torch.zeros((), dtype=torch.long, device=dev)

        def chunk():
            _iterate(benefit, col_valid, eps, price, owner, assign, iters,
                     CHECK_EVERY)
    assign.copy_(torch.where(col_valid, -1, -2))
    done = 0
    while done < max_iters and bool((assign == -1).any()):
        n = min(CHECK_EVERY, max_iters - done)
        if n == CHECK_EVERY:
            chunk()
        else:                            # the cap's last, shorter chunk
            _iterate(benefit, col_valid, eps, price, owner, assign, iters, n)
        done += n
    greedy = bool((assign == -1).any())
    if greedy:
        _greedy(benefit, owner, assign)
    STATS['problems'] += nb
    STATS['iterations'] += int(iters)
    STATS['greedy'] += int(greedy)
    return assign.clamp_min(0)


def auction_match(cost: torch.Tensor, col_valid: Optional[torch.Tensor] = None,
                  max_iters: int = 500, eps_frac: float = 2e-3
                  ) -> torch.Tensor:
    """The JAX package's single-phase Jacobi auction (matching.py:57-133) on
    the cost's device: cost (..., R, C) with R >= C, col_valid (..., C) bool
    (invalid columns get row 0) -> (..., C) int64, the matched row of each
    column. Leading dimensions are independent problems, as under
    ``jax.vmap``."""
    batch = cost.shape[:-2]
    benefit, valid, eps = _problems(cost, col_valid, eps_frac)
    return _solve(benefit, valid, eps, max_iters).reshape(
        *batch, cost.shape[-1])


def padded_problems(costs: Sequence[torch.Tensor],
                    col_valid: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every problem of `costs` (each (..., R, C)) in one batch padded to the
    largest R and C -> (benefit (N, C, R), col_valid (N, C), eps (N,)):
    padded rows have benefit -inf and padded columns are invalid, and each
    problem's eps is taken before the padding, so every problem's answer is
    its own."""
    probs = [_problems(c, v, 2e-3) for c, v in zip(costs, col_valid)]
    r = max(b.shape[2] for b, _, _ in probs)
    c = max(b.shape[1] for b, _, _ in probs)
    pad = torch.nn.functional.pad
    benefit = torch.cat([pad(pad(b, (0, r - b.shape[2]), value=-float('inf')),
                             (0, 0, 0, c - b.shape[1])) for b, _, _ in probs])
    valid = torch.cat([pad(v, (0, c - v.shape[1])) for _, v, _ in probs])
    return benefit, valid, torch.cat([e for _, _, e in probs])


def hungarian_match(costs: Sequence[torch.Tensor],
                    col_valid: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each cost (..., R, C) with R >= C, and its col_valid (..., C) -> the
    matched row per column (..., C), as ``auction_match`` gives it (the JAX
    package's ``hungarian_match``), all problems of the list solved as one
    batch (``padded_problems``)."""
    problems = padded_problems(costs, col_valid)
    with span('train.match'):
        rows = _solve(*problems, 500)
    out, off = [], 0
    for cost in costs:
        n = cost[..., 0, 0].numel()
        c = cost.shape[-1]
        out.append(rows[off:off + n, :c].reshape(cost.shape[:-2] + (c,)))
        off += n
    return out


def focal_cls_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                   weight: float = 2.0, alpha: float = 0.25,
                   gamma: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """mmdet FocalLossCost (matching.py:146-155), batched: logits
    (B, Q, ncls) x labels (B, G) -> (B, Q, G)."""
    p = cls_logits.sigmoid()
    neg = -(1 - p + eps).log() * (1 - alpha) * p ** gamma
    pos = -(p + eps).log() * alpha * (1 - p) ** gamma
    idx = gt_labels[:, None, :].expand(-1, p.shape[1], -1)
    return (pos.gather(2, idx) - neg.gather(2, idx)) * weight


def l1_bbox_cost(bbox_pred: torch.Tensor, gt_norm: torch.Tensor,
                 weight: float = 0.25) -> torch.Tensor:
    """BBox3DL1Cost (matching.py:158-162), batched: L1 distance over the
    first 8 code dims, (B, Q, code) x (B, G, code) -> (B, Q, G)."""
    diff = (bbox_pred[:, :, None, :8] - gt_norm[:, None, :, :8]).abs()
    return diff.sum(-1) * weight


def iou_xyxy_pair(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7):
    """matching.py:165-180: pairwise IoU and gIoU of xyxy boxes a (P, 4) and
    b (G, 4) -> two (P, G)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None]
    union = (area_a + area_b - inter).clamp_min(eps)
    elt = torch.minimum(a[:, None, :2], b[None, :, :2])
    erb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    ewh = (erb - elt).clamp_min(0)
    enc = (ewh[..., 0] * ewh[..., 1]).clamp_min(eps)
    iou = inter / union
    return iou, iou - (enc - union) / enc


def hungarian_2d_cost(cls_logits: torch.Tensor, boxes_cxcywh: torch.Tensor,
                      centers: torch.Tensor, gt_boxes_xyxy: torch.Tensor,
                      gt_labels: torch.Tensor, gt_centers: torch.Tensor,
                      img_hw, cls_weight: float = 2.0, reg_weight: float = 5.0,
                      iou_weight: float = 2.0, center_weight: float = 1.0
                      ) -> torch.Tensor:
    """The 2D matching cost of HungarianAssigner2D (matching.py:183-210;
    registered by the reference, unused by the shipped config, which takes
    SimOTA): focal class + normalized L1 + gIoU + center L1, (P, G)."""
    h, w = img_hw
    norm = torch.tensor([w, h, w, h], dtype=torch.float32,
                        device=cls_logits.device)
    cls_cost = focal_cls_cost(cls_logits[None], gt_labels[None],
                              weight=cls_weight)[0]
    gt_cxcywh = torch.stack([
        (gt_boxes_xyxy[:, 0] + gt_boxes_xyxy[:, 2]) / 2,
        (gt_boxes_xyxy[:, 1] + gt_boxes_xyxy[:, 3]) / 2,
        gt_boxes_xyxy[:, 2] - gt_boxes_xyxy[:, 0],
        gt_boxes_xyxy[:, 3] - gt_boxes_xyxy[:, 1]], dim=-1)
    reg_cost = (boxes_cxcywh[:, None] / norm
                - gt_cxcywh[None] / norm).abs().sum(-1) * reg_weight
    pred_xyxy = torch.cat([boxes_cxcywh[:, :2] - boxes_cxcywh[:, 2:] / 2,
                           boxes_cxcywh[:, :2] + boxes_cxcywh[:, 2:] / 2],
                          dim=-1)
    _, giou = iou_xyxy_pair(pred_xyxy, gt_boxes_xyxy)
    ctr_cost = (centers[:, None] / norm[:2]
                - gt_centers[None] / norm[:2]).abs().sum(-1) * center_weight
    return cls_cost + reg_cost - giou * iou_weight + ctr_cost
