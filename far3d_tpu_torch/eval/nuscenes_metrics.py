"""nuScenes 3D detection metrics (mAP / TP errors / NDS), in-house: a copy of
``far3d_tpu/eval/nuscenes_metrics.py`` (plain numpy), kept here so that the
port never imports the JAX package.

The reference's nuScenes path delegates evaluation to the mmdet3d
`NuScenesDataset.evaluate` (datasets/nuscenes_dataset.py:23 inherits it),
which in turn runs the nuscenes-devkit `DetectionEval` — an L0 external
dependency (SURVEY.md §2.4) that is not available in this image. This module
reimplements the official metric math (devkit detection/algo.py semantics,
config `detection_cvpr_2019`):

  * per-class detection range gate (50/40/30 m by class), BEV center
    distance matching at thresholds {0.5, 1, 2, 4} m, greedy by score,
    within-sample, accumulated globally per (class, threshold)
  * AP = normalized area of the 101-point interpolated PR curve above
    10% recall and 10% precision
  * TP errors at the 2 m threshold, cumulative-mean curves interpolated on
    the confidence grid, averaged from 10% recall to the max achieved
    recall: ATE (BEV m), ASE (1 - aligned 3D IoU), AOE (rad; period pi for
    barrier, 2pi otherwise), AVE (BEV m/s), AAE (1 - attribute accuracy)
  * class-metric exclusions: traffic_cone has no AOE/AVE/AAE; barrier has
    no AVE/AAE
  * NDS = (5 * mAP + sum_tp (1 - min(1, err))) / 10

Box rows are (x, y, z, w, l, h, yaw, vx, vy) in the ego/global frame the
ranges are measured in. Attributes are small ints into `NUSC_ATTRIBUTES`;
`default_attributes` reproduces the mmdet3d velocity heuristic used when a
model (like StreamPETR here) predicts no attribute head.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from .av2_metrics import iou_3d_axis_aligned

NUSC_CLASS_NAMES = (
    'car', 'truck', 'construction_vehicle', 'bus', 'trailer', 'barrier',
    'motorcycle', 'bicycle', 'pedestrian', 'traffic_cone')

# detection_cvpr_2019 class_range
NUSC_CLASS_RANGES: Mapping[str, float] = {
    'car': 50.0, 'truck': 50.0, 'bus': 50.0, 'trailer': 50.0,
    'construction_vehicle': 50.0, 'pedestrian': 40.0, 'motorcycle': 40.0,
    'bicycle': 40.0, 'traffic_cone': 30.0, 'barrier': 30.0}

NUSC_ATTRIBUTES = (
    '', 'vehicle.moving', 'vehicle.parked', 'vehicle.stopped',
    'cycle.with_rider', 'cycle.without_rider', 'pedestrian.moving',
    'pedestrian.standing', 'pedestrian.sitting_lying_down')

# mmdet3d DefaultAttribute (used when speed <= 0.2 m/s, with exceptions)
_DEFAULT_ATTR = {
    'car': 'vehicle.parked', 'truck': 'vehicle.parked',
    'trailer': 'vehicle.parked', 'construction_vehicle': 'vehicle.parked',
    'bus': 'vehicle.moving', 'motorcycle': 'cycle.without_rider',
    'bicycle': 'cycle.without_rider', 'pedestrian': 'pedestrian.moving',
    'barrier': '', 'traffic_cone': ''}

# class-metric pairs the official protocol excludes
_EXCLUDED = {
    ('traffic_cone', 'orient_err'), ('traffic_cone', 'vel_err'),
    ('traffic_cone', 'attr_err'),
    ('barrier', 'vel_err'), ('barrier', 'attr_err')}

TP_METRICS = ('trans_err', 'scale_err', 'orient_err', 'vel_err', 'attr_err')
_TP_LABELS = {'trans_err': 'ATE', 'scale_err': 'ASE', 'orient_err': 'AOE',
              'vel_err': 'AVE', 'attr_err': 'AAE'}


@dataclasses.dataclass(frozen=True)
class NuScenesDetectionConfig:
    class_names: Tuple[str, ...] = NUSC_CLASS_NAMES
    dist_thresholds_m: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0)
    tp_threshold_m: float = 2.0
    min_recall: float = 0.1
    min_precision: float = 0.1
    max_boxes_per_sample: int = 500
    num_recall_samples: int = 101

    def class_range(self, name: str) -> float:
        return NUSC_CLASS_RANGES.get(name, 50.0)


def default_attributes(class_names: Sequence[str], labels: np.ndarray,
                       velocities: np.ndarray) -> np.ndarray:
    """mmdet3d's velocity-heuristic attribute assignment for models without
    an attribute head (NuScenesDataset._format_bbox semantics)."""
    attrs = np.zeros(len(labels), np.int64)
    speed = np.linalg.norm(np.asarray(velocities)[:, :2], axis=1)
    for i, (lbl, sp) in enumerate(zip(labels, speed)):
        name = class_names[int(lbl)]
        if sp > 0.2 and name in ('car', 'construction_vehicle', 'bus',
                                 'truck', 'trailer'):
            attr = 'vehicle.moving'
        elif sp > 0.2 and name in ('bicycle', 'motorcycle'):
            attr = 'cycle.with_rider'
        elif sp <= 0.2 and name == 'pedestrian':
            attr = 'pedestrian.standing'
        elif sp <= 0.2 and name == 'bus':
            attr = 'vehicle.stopped'
        else:
            attr = _DEFAULT_ATTR.get(name, '')
        attrs[i] = NUSC_ATTRIBUTES.index(attr)
    return attrs


def _yaw_diff(a: np.ndarray, b: np.ndarray, period: float) -> np.ndarray:
    d = np.abs(a - b) % period
    return np.minimum(d, period - d)


def _cummean(x: np.ndarray) -> np.ndarray:
    return np.cumsum(x) / np.arange(1, len(x) + 1)


def _accumulate_class(dts_by_sample, gts_by_sample, dist_th: float,
                      cfg: NuScenesDetectionConfig, period: float,
                      npos: int):
    """Global score-ranked greedy matching for one (class, threshold).

    dts_by_sample: {sample: (boxes (N,9), scores (N,), attrs (N,))}
    gts_by_sample: {sample: (boxes (M,9), attrs (M,))}
    Returns (tp, fp, conf, match_errors dict) in global score order.
    """
    rows = []
    for sample, (boxes, scores, attrs) in dts_by_sample.items():
        for i in range(len(scores)):
            rows.append((float(scores[i]), sample, i))
    rows.sort(key=lambda r: -r[0])

    # per-sample free-GT masks so the greedy inner search is one vectorized
    # argmin per detection (the score-ordered outer loop must stay serial)
    free = {s: np.ones(len(g[0]), bool) for s, g in gts_by_sample.items()}
    tp, fp, conf = [], [], []
    errs = {k: [] for k in TP_METRICS}
    err_conf = []
    for score, sample, i in rows:
        box = dts_by_sample[sample][0][i]
        gt_boxes, gt_attrs = gts_by_sample.get(sample, (np.zeros((0, 9)),
                                                        np.zeros(0)))
        best = -1
        if len(gt_boxes):
            d = np.hypot(box[0] - gt_boxes[:, 0], box[1] - gt_boxes[:, 1])
            d = np.where(free[sample], d, np.inf)
            j = int(np.argmin(d))
            if d[j] < dist_th:
                best, best_d = j, float(d[j])
        conf.append(score)
        if best < 0:
            tp.append(0)
            fp.append(1)
            continue
        free[sample][best] = False
        tp.append(1)
        fp.append(0)
        g = gt_boxes[best]
        errs['trans_err'].append(best_d)
        errs['scale_err'].append(
            1.0 - float(iou_3d_axis_aligned(box[None, 3:6], g[None, 3:6])[0]))
        errs['orient_err'].append(float(_yaw_diff(box[6], g[6], period)))
        errs['vel_err'].append(float(np.hypot(box[7] - g[7], box[8] - g[8])))
        errs['attr_err'].append(
            0.0 if int(dts_by_sample[sample][2][i]) == int(gt_attrs[best])
            else 1.0)
        err_conf.append(score)

    tp = np.asarray(tp, np.float64)
    fp = np.asarray(fp, np.float64)
    conf = np.asarray(conf, np.float64)
    if len(tp) == 0 or npos == 0:
        return None

    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
    recall = tp_c / npos

    rec_interp = np.linspace(0, 1, cfg.num_recall_samples)
    prec_i = np.interp(rec_interp, recall, precision, right=0)
    conf_i = np.interp(rec_interp, recall, conf, right=0)

    md = {'precision': prec_i, 'confidence': conf_i}
    err_conf = np.asarray(err_conf, np.float64)
    for k in TP_METRICS:
        e = np.asarray(errs[k], np.float64)
        if len(e) == 0:
            md[k] = np.ones(cfg.num_recall_samples)
            continue
        cm = _cummean(e)
        # interpolate the cumulative-mean error curve onto the confidence
        # grid (devkit algo.py: np.interp needs increasing x, so reverse)
        md[k] = np.interp(conf_i[::-1], err_conf[::-1], cm[::-1])[::-1]
    return md


def _calc_ap(md, cfg: NuScenesDetectionConfig) -> float:
    prec = np.copy(md['precision'])
    prec = prec[round(100 * cfg.min_recall) + 1:]
    prec -= cfg.min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - cfg.min_precision)


def _calc_tp(md, cfg: NuScenesDetectionConfig, metric: str) -> float:
    first = round(100 * cfg.min_recall) + 1
    nonzero = np.nonzero(md['confidence'])[0]
    last = int(nonzero.max()) if len(nonzero) else 0
    if last < first:
        return 1.0
    return float(np.mean(md[metric][first:last + 1]))


def evaluate_nuscenes(detections: Sequence[Dict],
                      annotations: Sequence[Dict],
                      cfg: Optional[NuScenesDetectionConfig] = None):
    """Full nuScenes-protocol evaluation.

    detections: per-sample dicts with keys sample_token, boxes (N, 9:
        x y z w l h yaw vx vy), scores (N,), labels (N,), optional attrs
        (N,) int indices into NUSC_ATTRIBUTES (defaulted by velocity
        heuristic when absent).
    annotations: per-sample dicts with sample_token, boxes (M, 9), labels,
        optional attrs, optional num_pts (GTs with num_pts == 0 dropped,
        matching the devkit's lidar+radar point filter).

    Returns (summary: {class: {AP@th..., AP, ATE, ASE, AOE, AVE, AAE}},
             means: {mAP, mATE, mASE, mAOE, mAVE, mAAE, NDS}).
    """
    cfg = cfg or NuScenesDetectionConfig()
    names = cfg.class_names

    dts = {c: {} for c in names}
    gts = {c: {} for c in names}
    npos = {c: 0 for c in names}
    for rec in detections:
        sample = rec['sample_token']
        boxes = np.asarray(rec['boxes'], np.float64).reshape(-1, 9)
        scores = np.asarray(rec['scores'], np.float64)
        labels = np.asarray(rec['labels'], np.int64)
        if len(scores) > cfg.max_boxes_per_sample:
            keep = np.argsort(-scores)[:cfg.max_boxes_per_sample]
            boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
        attrs = (np.asarray(rec['attrs'], np.int64) if 'attrs' in rec
                 else default_attributes(names, labels, boxes[:, 7:9]))
        for ci, c in enumerate(names):
            m = (labels == ci) & (np.hypot(boxes[:, 0], boxes[:, 1])
                                  <= cfg.class_range(c))
            if m.any():
                dts[c][sample] = (boxes[m], scores[m], attrs[m])
    # AAE needs REAL annotation attributes; synthesizing GT attrs with the
    # prediction-side velocity heuristic would bias attr_err toward 0 (both
    # sides get the same guess). Without real GT attrs, AAE is reported n/a
    # and NDS renormalizes over the available terms (documented deviation).
    gt_attrs_real = all('attrs' in rec for rec in annotations)
    for rec in annotations:
        sample = rec['sample_token']
        boxes = np.asarray(rec['boxes'], np.float64).reshape(-1, 9)
        labels = np.asarray(rec['labels'], np.int64)
        keep = np.ones(len(labels), bool)
        if 'num_pts' in rec:
            keep &= np.asarray(rec['num_pts']) > 0
        attrs = (np.asarray(rec['attrs'], np.int64) if 'attrs' in rec
                 else np.zeros(len(labels), np.int64))
        for ci, c in enumerate(names):
            m = keep & (labels == ci) & (np.hypot(boxes[:, 0], boxes[:, 1])
                                         <= cfg.class_range(c))
            if m.any():
                gts[c][sample] = (boxes[m], attrs[m])
                npos[c] += int(m.sum())

    summary = {}
    for c in names:
        if npos[c] == 0:
            continue
        period = np.pi if c == 'barrier' else 2 * np.pi
        row = {'num_gts': npos[c]}
        aps = []
        tp_md = None
        for th in cfg.dist_thresholds_m:
            md = _accumulate_class(dts[c], gts[c], th, cfg, period, npos[c])
            ap = _calc_ap(md, cfg) if md is not None else 0.0
            row[f'AP@{th:g}'] = ap
            aps.append(ap)
            if th == cfg.tp_threshold_m:
                tp_md = md
        row['AP'] = float(np.mean(aps))
        for k in TP_METRICS:
            label = _TP_LABELS[k]
            if (c, k) in _EXCLUDED or (k == 'attr_err'
                                       and not gt_attrs_real):
                row[label] = np.nan
            elif tp_md is None:
                row[label] = 1.0
            else:
                row[label] = _calc_tp(tp_md, cfg, k)
        summary[c] = row

    if not summary:
        return summary, {}
    means = {'mAP': float(np.mean([r['AP'] for r in summary.values()]))}
    for k in TP_METRICS:
        label = _TP_LABELS[k]
        vals = [r[label] for r in summary.values()
                if not np.isnan(r[label])]
        means['m' + label] = float(np.mean(vals)) if vals else np.nan
    # NDS = (5 mAP + sum_tp (1 - min(1, err))) / 10; a TP metric whose mean
    # is undefined (no real GT attributes anywhere) drops out of both the
    # numerator and the denominator instead of silently counting as 0 or 1
    nds = 5.0 * means['mAP']
    denom = 5.0
    for k in TP_METRICS:
        v = means['m' + _TP_LABELS[k]]
        if not np.isnan(v):
            nds += 1.0 - min(1.0, v)
            denom += 1.0
    means['NDS'] = nds / denom
    return summary, means


def format_nuscenes_summary(summary: Dict, means: Dict) -> str:
    lines = [f'{"class":22s} {"AP":>6s} {"ATE":>6s} {"ASE":>6s} {"AOE":>6s}'
             f' {"AVE":>6s} {"AAE":>6s} {"#gt":>7s}']
    for c, r in sorted(summary.items()):
        cells = [f'{r["AP"]:6.3f}']
        for lab in ('ATE', 'ASE', 'AOE', 'AVE', 'AAE'):
            cells.append('   n/a' if np.isnan(r[lab]) else f'{r[lab]:6.3f}')
        lines.append(f'{c:22s} ' + ' '.join(cells) + f' {r["num_gts"]:7d}')
    if means:
        lines.append(
            f'{"MEANS":22s} {means["mAP"]:6.3f} {means["mATE"]:6.3f} '
            f'{means["mASE"]:6.3f} {means["mAOE"]:6.3f} '
            f'{means["mAVE"]:6.3f} {means["mAAE"]:6.3f}   '
            f'NDS={means["NDS"]:.4f}')
    return '\n'.join(lines)
