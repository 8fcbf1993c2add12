"""Argoverse 2 3D detection metrics, implemented in-house (a copy of
``far3d_tpu/eval/av2_metrics.py``).

Replaces the reference's av2-devkit-backed evaluation
(datasets/av2_utils.py:34-237, summarize_metrics_av2.py:44-192,
av2_eval_util.py:60-156) — the devkit is not available in this image, so the
official metric math is reimplemented:

  * greedy score-ranked TP assignment at center-distance thresholds
    (0.5/1/2/4 m), eval range (0, 150) m, <=100 dts/category/sweep
  * ATE (translation L2), ASE (1 - axis-aligned 3D IoU of centered boxes),
    AOE (av2 wrap_angles: |dyaw| reflected into [0, pi])
  * VOC-interpolated AP over 100 recall samples
  * CDS = mAP * mean(1 - err / norm), norms (2.0 m, 1.0, pi)

HD-map ROI masking (av2_eval_util.py:158-176 `load_mapped_avm_and_egoposes` +
the per-sweep ROI gate) is supported through the `roi_masks` argument of
`evaluate_detections`: a per-log (or per-sweep) `RasterROI` — a rasterized
drivable-area grid in the same frame as the boxes — gates which detections
and GTs count as evaluated, exactly where the reference applies its
rasterized static-map test. Without `roi_masks`, GT filtering falls back to
num_interior_pts > 0 and the range gate (documented deviation, PARITY.md).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..config import AV2_CLASS_NAMES

EPS = np.finfo(np.float64).eps
MAX_SCALE_ERROR = 1.0
MAX_YAW_RAD_ERROR = float(np.pi)
MIN_AP = 0.0


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    affinity_thresholds_m: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0)
    categories: Tuple[str, ...] = AV2_CLASS_NAMES
    max_num_dts_per_category: int = 100
    eval_range_m: Tuple[float, float] = (0.0, 150.0)
    num_recall_samples: int = 100
    tp_threshold_m: float = 2.0

    @property
    def tp_normalization_terms(self) -> np.ndarray:
        return np.asarray([self.tp_threshold_m, MAX_SCALE_ERROR,
                           MAX_YAW_RAD_ERROR])


@dataclasses.dataclass(frozen=True)
class RasterROI:
    """Rasterized region-of-interest mask (the reference's rasterized HD-map
    drivable area, av2_eval_util.py:158-318 ArgoverseStaticMapRemote).

    grid[r, c] is True where the cell is inside the ROI; the cell of a point
    (x, y) is ((y - origin[1]) // resolution, (x - origin[0]) // resolution).
    Points outside the grid are outside the ROI.
    """
    grid: np.ndarray                 # (H, W) bool
    origin_xy: Tuple[float, float]   # world coords of grid[0, 0]
    resolution_m: float = 0.5

    def contains(self, xy: np.ndarray) -> np.ndarray:
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        col = np.floor((xy[:, 0] - self.origin_xy[0])
                       / self.resolution_m).astype(np.int64)
        row = np.floor((xy[:, 1] - self.origin_xy[1])
                       / self.resolution_m).astype(np.int64)
        h, w = self.grid.shape
        ok = (row >= 0) & (row < h) & (col >= 0) & (col < w)
        out = np.zeros(len(xy), bool)
        out[ok] = self.grid[row[ok], col[ok]]
        return out


def wrap_angles(angles: np.ndarray, period: float = np.pi) -> np.ndarray:
    """av2.geometry.geometry.wrap_angles: |angle| reflected into [0, pi]."""
    angles = np.abs(np.asarray(angles, np.float64))
    divs, mods = np.divmod(angles, period)
    out = np.where(divs > 0, period - mods, mods)
    return out


def iou_3d_axis_aligned(dims_a: np.ndarray, dims_b: np.ndarray) -> np.ndarray:
    """Axis-aligned IoU of co-centered boxes (av2 scale error)."""
    inter = np.prod(np.minimum(dims_a, dims_b), axis=-1)
    union = (np.prod(dims_a, axis=-1) + np.prod(dims_b, axis=-1) - inter)
    return inter / np.maximum(union, EPS)


def accumulate_sweep(dts: np.ndarray, gts: np.ndarray,
                     cfg: DetectionConfig,
                     roi: Optional[RasterROI] = None):
    """One (log, timestamp, category) sweep (av2_utils.py:70-157).

    dts: (N, 11) rows [tx,ty,tz,l,w,h,yaw, vx,vy? no] — here rows are
         [tx,ty,tz, l, w, h, yaw, score]
    gts: (M, 8)  rows [tx,ty,tz, l, w, h, yaw, num_interior_pts]

    Returns (dts_aug (N, T+3+1), gts_aug (M, T+3+1), dt_scores (N,)):
    per-threshold TP flags, then ATE/ASE/AOE, then is_evaluated.
    """
    n, m = len(dts), len(gts)
    t = len(cfg.affinity_thresholds_m)
    order = np.argsort(-dts[:, -1], kind='stable') if n else np.zeros(0, int)
    dts = dts[order]

    lo, hi = cfg.eval_range_m
    def in_range(x):
        r = np.linalg.norm(x[:, :3], axis=1)
        return (r > lo) & (r < hi)

    ev_dts = in_range(dts) if n else np.zeros(0, bool)
    if roi is not None and n:
        ev_dts &= roi.contains(dts[:, :2])     # HD-map ROI gate
    # cap to max dts per category (score-ordered cumulative)
    if n:
        cum = np.cumsum(ev_dts)
        over = np.where(cum > cfg.max_num_dts_per_category)[0]
        if len(over):
            ev_dts[over[0]:] = False
    ev_gts = (in_range(gts) & (gts[:, 7] > 0)) if m else np.zeros(0, bool)
    if roi is not None and m:
        ev_gts &= roi.contains(gts[:, :2])

    dts_aug = np.zeros((n, t + 4))
    gts_aug = np.zeros((m, t + 4))
    dts_aug[ev_dts, -1] = 1
    gts_aug[ev_gts, -1] = 1
    dts_aug[:, t:t + 3] = [cfg.tp_threshold_m, MAX_SCALE_ERROR,
                           MAX_YAW_RAD_ERROR]

    if ev_dts.sum() and ev_gts.sum():
        d = dts[ev_dts]
        g = gts[ev_gts]
        aff = -np.linalg.norm(d[:, None, :3] - g[None, :, :3], axis=-1)
        idx_g_per_d = aff.argmax(axis=1)
        best_aff = aff[np.arange(len(d)), idx_g_per_d]
        # first (highest-score) detection per GT
        idx_gts, idx_dts = np.unique(idx_g_per_d, return_index=True)
        sub = np.zeros((len(d), t + 3))
        sub[:, t:] = [cfg.tp_threshold_m, MAX_SCALE_ERROR, MAX_YAW_RAD_ERROR]
        gsub = np.zeros((len(g), t + 3))
        for i, thr in enumerate(cfg.affinity_thresholds_m):
            is_tp = best_aff[idx_dts] > -thr
            sub[idx_dts[is_tp], i] = 1
            gsub[idx_gts, i] = 1
            if thr == cfg.tp_threshold_m and np.any(is_tp):
                td = d[idx_dts[is_tp]]
                tg = g[idx_gts[is_tp]]
                ate = np.linalg.norm(td[:, :3] - tg[:, :3], axis=1)
                ase = 1 - iou_3d_axis_aligned(td[:, 3:6], tg[:, 3:6])
                aoe = wrap_angles(td[:, 6] - tg[:, 6])
                sub[idx_dts[is_tp], t:] = np.stack([ate, ase, aoe], axis=-1)
        dts_aug[ev_dts, :-1] = sub
        gts_aug[ev_gts, :-1] = gsub

    return dts_aug, gts_aug, dts[:, -1]


def evaluate_detections(detections: Sequence[Dict],
                        annotations: Sequence[Dict],
                        cfg: Optional[DetectionConfig] = None,
                        roi_masks: Optional[Dict] = None,
                        workers: int = 0):
    """Full evaluation (av2_eval_util.py:60-156 + summarize_metrics).

    detections: per-frame dicts with keys log_id, timestamp_ns,
        boxes (N, 7) [tx,ty,tz(gravity),l,w,h,yaw], scores (N,), labels (N,).
    annotations: per-frame dicts with keys log_id, timestamp_ns,
        boxes (M, 7), labels (M,), num_interior_pts (M,).
    roi_masks: optional {log_id: RasterROI} or {(log_id, timestamp_ns):
        RasterROI} — HD-map ROI gating as in av2_eval_util.py:158-176; boxes
        outside the raster are excluded from both dts and gts. Sweeps with no
        entry fall back to the range-only gate.
    workers: > 0 fans the per-sweep accumulation over a thread pool (the
        reference parallelizes with a joblib pool, av2_utils.py evaluate;
        numpy releases the GIL on the heavy ops).

    Returns (summary dict per category, means dict with mAP/ATE/ASE/AOE/CDS).
    """
    cfg = cfg or DetectionConfig()
    cats = list(cfg.categories)
    per_key_dts = defaultdict(list)
    per_key_gts = defaultdict(list)
    for det in detections:
        boxes = np.asarray(det['boxes'], np.float64).reshape(-1, 7)
        scores = np.asarray(det['scores'], np.float64).reshape(-1)
        labels = np.asarray(det['labels'], np.int64).reshape(-1)
        for c in np.unique(labels):
            sel = labels == c
            rows = np.concatenate([boxes[sel], scores[sel, None]], axis=1)
            per_key_dts[(det['log_id'], det['timestamp_ns'], int(c))].append(rows)
    for ann in annotations:
        boxes = np.asarray(ann['boxes'], np.float64).reshape(-1, 7)
        labels = np.asarray(ann['labels'], np.int64).reshape(-1)
        pts = np.asarray(ann.get('num_interior_pts',
                                 np.ones(len(boxes))), np.float64).reshape(-1)
        for c in np.unique(labels):
            sel = labels == c
            rows = np.concatenate([boxes[sel], pts[sel, None]], axis=1)
            per_key_gts[(ann['log_id'], ann['timestamp_ns'], int(c))].append(rows)

    t = len(cfg.affinity_thresholds_m)
    cat_dts = defaultdict(list)    # category -> (scores, aug rows)
    cat_gts_evaluated = defaultdict(int)
    all_keys = sorted(set(per_key_dts) | set(per_key_gts))

    def one_sweep(key):
        log_id, ts, c = key
        d = np.concatenate(per_key_dts[key], axis=0) if key in per_key_dts \
            else np.zeros((0, 8))
        g = np.concatenate(per_key_gts[key], axis=0) if key in per_key_gts \
            else np.zeros((0, 8))
        roi = None
        if roi_masks is not None:
            roi = roi_masks.get((log_id, ts), roi_masks.get(log_id))
        return c, accumulate_sweep(d, g, cfg, roi)

    if workers > 0:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            sweep_results = list(pool.map(one_sweep, all_keys))
    else:
        sweep_results = [one_sweep(k) for k in all_keys]
    for c, (daug, gaug, dscores) in sweep_results:
        cat_dts[c].append((dscores, daug))
        cat_gts_evaluated[c] += int(gaug[:, -1].sum())

    recall_interp = np.linspace(0, 1, cfg.num_recall_samples, endpoint=True)
    norms = cfg.tp_normalization_terms
    summary = {}
    for ci, cat in enumerate(cats):
        num_gts = cat_gts_evaluated.get(ci, 0)
        if num_gts == 0:
            continue
        if cat_dts.get(ci):
            scores = np.concatenate([s for s, _ in cat_dts[ci]])
            aug = np.concatenate([a for _, a in cat_dts[ci]], axis=0)
        else:
            scores = np.zeros(0)
            aug = np.zeros((0, t + 4))
        keep = aug[:, -1] > 0
        scores, aug = scores[keep], aug[keep]
        order = np.argsort(-scores, kind='stable')
        aug = aug[order]

        aps = []
        for i in range(t):
            tp = aug[:, i].astype(bool)
            if len(tp) == 0:
                aps.append(0.0)
                continue
            cum_tp = np.cumsum(tp)
            cum_fp = np.cumsum(~tp)
            prec = cum_tp / (cum_tp + cum_fp + EPS)
            rec = cum_tp / num_gts
            prec = np.maximum.accumulate(prec[::-1])[::-1]
            prec_i = np.interp(recall_interp, rec, prec, right=0)
            aps.append(float(np.mean(prec_i)))
        m_ap = float(np.mean(aps))

        mid = cfg.affinity_thresholds_m[t // 2]
        mid_i = cfg.affinity_thresholds_m.index(mid)
        is_tp = aug[:, mid_i].astype(bool)
        if np.any(is_tp):
            tp_err = aug[is_tp][:, t:t + 3].mean(axis=0)
        else:
            tp_err = norms.copy()
        tp_scores = 1 - tp_err / norms
        cds = m_ap * float(np.mean(tp_scores))
        summary[cat] = dict(AP=m_ap, ATE=float(tp_err[0]), ASE=float(tp_err[1]),
                            AOE=float(tp_err[2]), CDS=cds, num_gts=num_gts)

    if summary:
        means = {k: float(np.mean([v[k] for v in summary.values()]))
                 for k in ('AP', 'ATE', 'ASE', 'AOE', 'CDS')}
        means['mAP'] = means.pop('AP')
    else:
        means = dict(mAP=0.0, ATE=2.0, ASE=1.0, AOE=float(np.pi), CDS=0.0)
    return summary, means


def format_summary(summary: Dict, means: Dict,
                   class_names: Sequence[str] = AV2_CLASS_NAMES) -> str:
    lines = [f"{'category':36s} {'AP':>7s} {'ATE':>7s} {'ASE':>7s} "
             f"{'AOE':>7s} {'CDS':>7s} {'#gts':>7s}"]
    for cat in class_names:
        if cat in summary:
            s = summary[cat]
            lines.append(f"{cat:36s} {s['AP']:7.4f} {s['ATE']:7.4f} "
                         f"{s['ASE']:7.4f} {s['AOE']:7.4f} {s['CDS']:7.4f} "
                         f"{s['num_gts']:7d}")
    lines.append(f"{'MEAN':36s} {means['mAP']:7.4f} {means['ATE']:7.4f} "
                 f"{means['ASE']:7.4f} {means['AOE']:7.4f} {means['CDS']:7.4f}")
    return '\n'.join(lines)
