"""Streaming evaluation runner (counterpart of ``far3d_tpu/eval/runner.py``;
reference core/apis/test.py:45-160 + argoverse2_dataset.evaluate).

Each rank streams its contiguous, temporally ordered shard through the
inference step, carrying the temporal memory; scene changes arrive as
prev_exists=0 from the dataset. Results are written as per-rank files; rank
0 concatenates them in rank order and computes the AV2 metrics. The AV2
feather submission (pandas) is not ported.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Far3DConfig
from ..data.loader import BATCH_KEYS
from ..entry import resolve_device
from ..models.detector import Far3D
from ..models.farhead import init_state
from ..train.step import make_infer_step
from .av2_metrics import DetectionConfig, evaluate_detections, format_summary


def _upload_ahead(loader, device: torch.device):
    """Yield (frame, batch on `device`), the next frame's host-to-device
    copy enqueued on a side stream before the current frame is handed out,
    so that it overlaps the current frame's compute (images ship uint8 from
    page-locked memory)."""
    if device.type != 'cuda':
        for frame in loader:
            yield frame, {k: frame[k][None] for k in BATCH_KEYS}
        return
    side = torch.cuda.Stream(device)
    pending = None
    for frame in loader:
        with torch.cuda.stream(side):
            batch = {k: frame[k][None].to(device, non_blocking=True)
                     for k in BATCH_KEYS}
            done = torch.cuda.Event()
            done.record(side)
        if pending is not None:
            yield _on_current_stream(*pending)
        pending = (frame, batch, done)
    if pending is not None:
        yield _on_current_stream(*pending)


def _on_current_stream(frame, batch, done):
    main = torch.cuda.current_stream()
    main.wait_event(done)
    for t in batch.values():
        t.record_stream(main)
    return frame, batch


def run_inference(cfg: Far3DConfig, model: Far3D, loader,
                  device=None) -> List[Dict]:
    """Stream one rank's shard (``data.loader.EvalLoader``) through `model`;
    returns per-frame detection dicts (boxes with gravity-centre z, their
    scores and labels, the frame's log id, timestamp and dataset index).
    Runs on the card unless `device` says otherwise; `model` must be on
    that device."""
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f'the model is on {model_device}, not on {device}')
    infer = make_infer_step(cfg)
    tstate = init_state(1, cfg.head, model_device)
    results = []
    for frame, batch in _upload_ahead(loader, model_device):
        dets, tstate = infer(model, tstate, batch)
        valid = dets['valid'][0].cpu().numpy()
        boxes = dets['boxes'][0].cpu().numpy()[valid]
        scores = dets['scores'][0].cpu().numpy()[valid]
        labels = dets['labels'][0].cpu().numpy()[valid]
        # bottom z -> gravity center z for AV2 rows
        boxes[:, 2] += boxes[:, 5] / 2
        results.append(dict(
            index=frame['index'],
            log_id=frame['scene_token'],
            timestamp_ns=int(frame['lidar_timestamp']),
            boxes=boxes[:, :7], scores=scores, labels=labels))
    # drop padded repeats at the shard tail
    if loader.pad:
        results = results[:-loader.pad]
    return results


def collect_and_evaluate(cfg: Far3DConfig, dataset, results_dir: str,
                         rank: int, world_size: int,
                         results: List[Dict],
                         eval_range_m: Optional[float] = None,
                         roi_masks=None):
    """Write per-rank shard files; rank 0 concatenates them in rank order
    (core/apis/test.py:116-160) and evaluates -> (summary, means), None on
    the other ranks."""
    os.makedirs(results_dir, exist_ok=True)
    with open(f'{results_dir}/part_{rank}.pkl', 'wb') as f:
        pickle.dump(results, f)
    if rank != 0:
        return None
    # wait for all parts (simple shared-file-system sync)
    parts = []
    for r in range(world_size):
        path = f'{results_dir}/part_{r}.pkl'
        for _ in range(600):
            if os.path.exists(path):
                break
            time.sleep(1)
        with open(path, 'rb') as f:
            parts.extend(pickle.load(f))

    # GT only for the frames actually evaluated: a capped run would
    # otherwise count every frame's GTs in the recall denominator
    evaluated = {p['index'] for p in parts}
    annotations = []
    for i in sorted(evaluated):
        rec = dataset.get_frame(i)
        if 'gt_boxes_3d' not in rec:
            continue
        annotations.append(dict(
            log_id=rec['scene_token'],
            timestamp_ns=int(rec['lidar_timestamp']),
            boxes=rec['gt_boxes_3d'][:, :7],
            labels=rec['gt_labels_3d'],
            num_interior_pts=np.ones(len(rec['gt_labels_3d']))))
    dc = DetectionConfig() if eval_range_m is None else DetectionConfig(
        eval_range_m=(0.0, eval_range_m))
    workers = min(8, os.cpu_count() or 1)
    summary, means = evaluate_detections(parts, annotations, dc,
                                         workers=workers,
                                         roi_masks=roi_masks)
    print(format_summary(summary, means))
    return summary, means
