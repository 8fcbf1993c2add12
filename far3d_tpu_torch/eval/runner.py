"""Streaming evaluation runner (counterpart of ``far3d_tpu/eval/runner.py``;
reference core/apis/test.py:45-160 + argoverse2_dataset.evaluate).

Each rank streams its contiguous, temporally ordered shard through the
inference step, carrying the temporal memory; scene changes arrive as
prev_exists=0 from the dataset. Results are written as per-rank files; rank
0 concatenates them in rank order and computes the AV2 metrics.
``format_av2_submission`` gives the AV2 submission's columns, which
``utils.feather.write_feather`` writes as the Feather file.
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
from ..parallel import mesh
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
                  device=None, quant_tree=None) -> List[Dict]:
    """Stream one rank's shard (``data.loader.EvalLoader``) through `model`;
    returns per-frame detection dicts (boxes with gravity-centre z, their
    scores and labels, the frame's log id, timestamp and dataset index).
    Runs on the card unless `device` says otherwise; `model` must be on
    that device. `quant_tree` (``ops/quant.py:quantize_detector_backbone``)
    serves with the int8 backbone in place of the bf16 one."""
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f'the model is on {model_device}, not on {device}')
    infer = make_infer_step(cfg)
    tstate = init_state(1, cfg.head, model_device)
    results = []
    for frame, batch in _upload_ahead(loader, model_device):
        dets, tstate = infer(model, tstate, batch, quant_tree)
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
    the other ranks: ``collect_parts`` then ``evaluate_parts``."""
    parts = collect_parts(results_dir, rank, world_size, results)
    if parts is None:
        return None
    return evaluate_parts(cfg, dataset, parts, eval_range_m, roi_masks)


def collect_parts(results_dir: str, rank: int, world_size: int,
                  results: List[Dict]) -> Optional[List[Dict]]:
    """Write this rank's `results` as ``part_<rank>.pkl``; on rank 0 return
    every rank's, concatenated in rank order (the whole evaluation, frame by
    frame in dataset order), None on the others. A part is written to a
    temporary name and renamed, so a part file is always whole; with a
    process group (``parallel/mesh.py``) a barrier tells rank 0 that every
    part is there, without one rank 0 waits up to 600 s for each file on
    the shared file system."""
    os.makedirs(results_dir, exist_ok=True)
    tmp = f'{results_dir}/.part_{rank}.pkl.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(results, f)
    os.replace(tmp, f'{results_dir}/part_{rank}.pkl')
    mesh.barrier()
    if rank != 0:
        return None
    parts = []
    for r in range(world_size):
        path = f'{results_dir}/part_{r}.pkl'
        for _ in range(600):
            if os.path.exists(path):
                break
            time.sleep(1)
        with open(path, 'rb') as f:
            parts.extend(pickle.load(f))
    return parts


def evaluate_parts(cfg: Far3DConfig, dataset, parts: List[Dict],
                   eval_range_m: Optional[float] = None,
                   roi_masks=None):
    """The AV2 metrics of the collected `parts` against `dataset`'s GT of
    the frames they hold -> (summary, means); prints the summary."""
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


def format_av2_submission(results: List[Dict], class_names
                          ) -> Dict[str, np.ndarray]:
    """Detections -> the AV2 submission's columns (argoverse2_dataset.py:
    267-331 format_results), in the JAX package's order and dtypes: log_id,
    timestamp_ns (int64), the box centre and size, the yaw as a quaternion
    about z, score (float64 each) and category (str), one row a box."""
    per_frame = [len(d['boxes']) for d in results]
    b = np.concatenate([np.asarray(d['boxes'], np.float64).reshape(-1, 7)
                        for d in results] or [np.zeros((0, 7))])
    half = b[:, 6] / 2
    return {
        'log_id': np.repeat(np.array([d['log_id'] for d in results],
                                     dtype=object), per_frame),
        'timestamp_ns': np.repeat(np.array(
            [d['timestamp_ns'] for d in results], np.int64), per_frame),
        'tx_m': b[:, 0], 'ty_m': b[:, 1], 'tz_m': b[:, 2],
        'length_m': b[:, 3], 'width_m': b[:, 4], 'height_m': b[:, 5],
        'qw': np.cos(half), 'qx': np.zeros(len(b)), 'qy': np.zeros(len(b)),
        'qz': np.sin(half),
        'score': np.concatenate([np.asarray(d['scores'], np.float64)
                                 for d in results] or [np.zeros(0)]),
        'category': np.array([class_names[int(label)] for d in results
                              for label in d['labels']], dtype=object),
    }
