"""Camera-sharded streaming inference (counterpart of
``far3d_tpu/parallel/cam_shard.py``): a latency mode for one stream.

The backbone, FPN, YOLOX 2D head and depth net see each camera on its own,
so they split over devices by camera: each device holds a replica of these
towers and runs its contiguous slice of the cameras. Their outputs are
gathered on ``devices[0]``, where the part of the frame that couples the
cameras runs as it does unsharded: the joint top-K proposals, the decoder
with ``msda_fwd`` over all cameras, the decode. The JAX package has GSPMD
split one jitted program over a ``cam`` mesh axis, and gives its Pallas
call a partitioning rule so that it runs under that mesh
(``msda_pallas.py:789-873``); here each device's slice is a plain call, so
neither is needed. The expected frame latency on N devices is about
backbone / N + decoder, not frame / N.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.detector import (Far3D, camera_towers, decode_detections,
                               normalize_images)


def cam_splits(n_cams: int, n_devices: int) -> List[Tuple[int, int]]:
    """The contiguous camera slices [lo, hi) of each of `n_devices` devices
    (twin of ``cam_shardings``: camera tensors split on axis 1), as even as
    they go, the first ones a camera longer; empty past `n_cams`."""
    base, extra = divmod(n_cams, n_devices)
    out, lo = [], 0
    for d in range(n_devices):
        hi = lo + base + (d < extra)
        out.append((lo, hi))
        lo = hi
    return out


class _Towers(nn.Module):
    """A replica of the per-camera towers on another device."""

    def __init__(self, model: Far3D, device: torch.device):
        super().__init__()
        for name in ('img_backbone', 'img_neck', 'img_roi_head'):
            self.add_module(name, copy.deepcopy(getattr(model, name)).to(device))


def _indexed(device) -> torch.device:
    """`device` with its index: 'cuda' is the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def _gather(slices: Sequence, b: int, device: torch.device):
    """Per-slice outputs ((b * n_slice, ...) tensors in equal nested
    structures) -> one structure of (b * n, ...) tensors on `device`,
    camera-minor, as the unsharded towers give them."""
    first = slices[0]
    if isinstance(first, dict):
        return {k: _gather([s[k] for s in slices], b, device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_gather([s[i] for s in slices], b, device)
                           for i in range(len(first)))
    parts = [t.to(device).reshape(b, -1, *t.shape[1:]) for t in slices]
    cat = torch.cat(parts, dim=1)
    return cat.reshape(-1, *cat.shape[2:])


def make_cam_sharded_infer(model: Far3D, cfg, devices: Optional[Sequence] = None):
    """-> ``run(tstate, kwargs) -> (detections, new_state)`` with the
    cameras split over `devices` (default: every card), the outputs on
    ``devices[0]``, where `model` must live.

    `kwargs` is the usual infer-step dict (images, lidar2img, intrinsics,
    extrinsics, prev_exists, timestamp, ego_pose, ego_pose_inv). As the JAX
    package's ``make_cam_mesh``, it needs at least as many devices as
    cameras and takes the first ``num_cams``, one camera each; a device may
    be listed more than once (several slices in turn on one card, or on
    the CPU). ``run.slices`` holds each device and its camera slice."""
    n_cams = cfg.data.num_cams
    if devices is None:
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    if len(devices) < n_cams:
        raise ValueError(f'camera sharding needs >= {n_cams} devices, have '
                         f'{len(devices)}')
    devices = devices[:n_cams]
    home = next(model.parameters()).device
    if home != devices[0]:
        raise ValueError(f'the model is on {home}, not on devices[0] = '
                         f'{devices[0]}')
    replicas: Dict[torch.device, nn.Module] = {home: model}
    for d in devices:
        if d not in replicas:
            replicas[d] = _Towers(model, d).eval()
    slices = list(zip(devices, cam_splits(n_cams, len(devices))))

    @torch.inference_mode()
    def run(tstate, kwargs):
        images = kwargs['images']
        b = images.shape[0]
        # every slice enqueued before any is gathered, so that devices overlap
        outs = []
        for dev, (lo, hi) in slices:
            x = normalize_images(images[:, lo:hi].to(dev), cfg)
            outs.append(camera_towers(replicas[dev], x))
        feats = _gather([o[0] for o in outs], b, home)
        outs2d = _gather([o[1] for o in outs], b, home)
        kw = {k: v.to(home) for k, v in kwargs.items() if k != 'images'}
        out = model.forward_head(
            feats, outs2d, b, n_cams, kw['lidar2img'], kw['intrinsics'],
            kw['extrinsics'], tstate, kw['prev_exists'], kw['timestamp'],
            kw['ego_pose'], kw['ego_pose_inv'])
        dets = decode_detections(out['all_cls_scores'][-1],
                                 out['all_bbox_preds'][-1],
                                 out['query_valid'], cfg)
        return dets, out['state']

    run.slices = slices
    return run
