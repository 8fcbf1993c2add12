"""StreamPETR-on-nuScenes streaming evaluation (counterpart of
``far3d_tpu/eval/petr_runner.py``).

nuScenes info pkl -> ``NuScenesSequenceDataset`` -> the shared
``EvalLoader`` and host pipeline -> the StreamPETR step with its temporal
carry and NMS-free decode (``train/petr_step.py:make_petr_infer_step``) ->
the in-house NDS protocol (``eval/nuscenes_metrics.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import DataConfig, Far3DConfig
from ..entry import resolve_device
from ..models.streampetr import StreamPETR, StreamPETRConfig, init_petr_state
from ..train.petr_step import make_petr_infer_step
from .nuscenes_metrics import (NuScenesDetectionConfig, evaluate_nuscenes,
                               format_nuscenes_summary)
from .runner import _upload_ahead


def petr_host_config(cfg: StreamPETRConfig,
                     src_wh: Tuple[int, int] = (1600, 900)) -> Far3DConfig:
    """A Far3DConfig whose data fields drive the shared host pipeline
    (``data/pipeline.process_frame``) for nuScenes cameras: a fixed resize
    that maps the source width onto the model's input width, and the bottom
    crop of StreamPETR's nuScenes recipe."""
    fh, fw = cfg.input_hw
    r = fw / src_wh[0]
    if int(src_wh[1] * r) < fh:
        raise ValueError(f'input_hw {cfg.input_hw} taller than resized '
                         f'source {src_wh} * {r}')
    return Far3DConfig(
        pc_range=cfg.pc_range,
        data=DataConfig(num_cams=cfg.num_cams, input_hw=cfg.input_hw,
                        resize_lim=(r, r), max_gt=160, max_gt_2d=96))


def run_inference_petr(cfg: StreamPETRConfig, model: StreamPETR, loader,
                       device=None, quant_tree=None) -> List[Dict]:
    """Stream `loader`'s frames (``data.loader.EvalLoader``) through `model`
    with the carried temporal state (reset by prev_exists) and return per
    frame its dataset index and the valid detections: boxes (N, 9) with
    bottom-centre z and velocity, scores, labels. Runs on the card unless
    `device` says otherwise; `model` must be on that device. `quant_tree`
    (``ops/quant.py:quantize_petr_backbone``) serves with the int8
    backbone."""
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f'the model is on {model_device}, not on {device}')
    infer = make_petr_infer_step(cfg)
    tstate = init_petr_state(1, cfg, model_device)
    results = []
    for frame, batch in _upload_ahead(loader, model_device):
        dets, tstate = infer(model, tstate, batch, quant_tree)
        valid = dets['valid'][0].cpu().numpy()
        results.append(dict(
            index=frame['index'],
            boxes=dets['boxes'][0].cpu().numpy().astype(np.float64)[valid],
            scores=dets['scores'][0].cpu().numpy().astype(np.float64)[valid],
            labels=dets['labels'][0].cpu().numpy().astype(np.int64)[valid]))
    if loader.pad:
        results = results[:-loader.pad]
    return results


def collect_and_evaluate_nusc(dataset, results: List[Dict],
                              cfg: Optional[NuScenesDetectionConfig] = None):
    """Pair each frame's detections with the dataset's GT and run the
    nuScenes protocol -> (summary, means)."""
    dts, gts = [], []
    for r in results:
        rec = dataset.get_frame(r['index'])
        token = f"{rec['scene_token']}/{rec['lidar_timestamp']}"
        dts.append(dict(sample_token=token, boxes=r['boxes'],
                        scores=r['scores'], labels=r['labels']))
        g = np.asarray(rec.get('gt_boxes_3d', np.zeros((0, 7))), np.float64)
        vel = np.asarray(rec.get('gt_velocity', np.zeros((len(g), 2))),
                         np.float64)
        gt = dict(sample_token=token,
                  boxes=np.concatenate([g, vel], axis=1),
                  labels=np.asarray(rec.get('gt_labels_3d', np.zeros(0)),
                                    np.int64))
        if 'gt_attrs' in rec:      # real annotation attributes (AAE)
            gt['attrs'] = np.asarray(rec['gt_attrs'], np.int64)
        gts.append(gt)
    summary, means = evaluate_nuscenes(dts, gts, cfg)
    print(format_nuscenes_summary(summary, means))
    return summary, means
