"""Host-side image pipeline (counterpart of ``far3d_tpu/data/pipeline.py``;
reference datasets/pipelines/custom_pipeline.py and transform_3d.py),
producing static-shape numpy arrays for one frame.

Stages per frame (train_pipeline, far3d.py:175-188):
  load BGR float32 -> [range/name filter done in dataset] ->
  AV2ResizeCropFlipRotImageV2 (per-camera random resize/crop; the portrait
  front camera is first turned landscape via a fixed center crop,
  custom_pipeline.py:71-111,328-338; intrinsics updated by the 3x3 ida
  matrix) -> Normalize (BGR mean/std, to_rgb=False) -> pad to the common max
  shape -> instance depth map painting at stride 8 with LID binning
  (custom_pipeline.py:445-537) -> static-budget padding of all GT.

All randomness comes from a numpy Generator owned by the caller (the streaming
sampler seeds one per (rank, lane)). Decoding and the one resampling pass per
camera go through ``image_io`` (the port's own JPEG and PNG decoders and
float32 warp) instead of OpenCV; the output has the JAX package's keys and dtypes, with
uint8 images.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import DataConfig, DepthNetConfig, Far3DConfig
from .image_io import read_image, warp_affine_inverse


def _pix_map(src_hw, dims, crop) -> np.ndarray:
    """3x3 dst->src pixel-center map of one resize+crop stage, matching
    cv2.resize's conventions: the effective scale is the integer-dims ratio
    src/dst (NOT the requested resize factor) per axis, with half-pixel
    centers (src_x = (dst_x + crop_x + 0.5) * src_w/dst_w - 0.5). Composable
    across stages; fed to ``warp_affine_inverse`` so each camera is resampled
    exactly once."""
    sh, sw = src_hw
    inv_x = sw / dims[0]
    inv_y = sh / dims[1]
    m = np.eye(3)
    m[0, 0] = inv_x
    m[1, 1] = inv_y
    m[0, 2] = (crop[0] + 0.5) * inv_x - 0.5
    m[1, 2] = (crop[1] + 0.5) * inv_y - 0.5
    return m


def sample_augmentation(rng: np.random.Generator, cfg: DataConfig,
                        h: int, w: int, train: bool):
    """custom_pipeline.py:313-326 (_sample_augmentation)."""
    fh, fw = cfg.input_hw
    if train:
        resize = float(rng.uniform(*cfg.resize_lim))
    else:
        # eval uses the same sampler; with bot_pct_lim=(0,0) the crop is
        # deterministic given resize; use the midpoint scale for determinism
        resize = float(sum(cfg.resize_lim)) / 2.0
    dims = (int(w * resize), int(h * resize))
    new_w, new_h = dims
    crop_h = new_h - fh                      # bot_pct_lim = (0, 0)
    crop_w = int(rng.uniform(0, max(0, new_w - fw))) if train else \
        max(0, (new_w - fw) // 2)
    crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
    return resize, dims, crop


def sample_augmentation_front(h: int, w: int):
    """Fixed portrait->landscape transform for the front camera
    (custom_pipeline.py:328-338): resize by round((H+50)/W, 2), center-crop to
    (W, H) swapped dims."""
    fh, fw = w, h
    resize = round((h + 50) / w, 2)
    dims = (int(w * resize), int(h * resize))
    new_w, new_h = dims
    crop_w = int((new_w - fw) / 2)
    crop_h = int((new_h - fh) / 2)
    crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
    return resize, dims, crop


def ida_matrix(resize: float, crop) -> np.ndarray:
    """3x3 post-homography for intrinsics update (custom_pipeline.py:295-311,
    no flip/rotation in the shipped config)."""
    m = np.eye(3, dtype=np.float64)
    m[0, 0] = m[1, 1] = resize
    m[0, 2] = -crop[0]
    m[1, 2] = -crop[1]
    return m


def transform_boxes(bboxes, centers2d, labels, depths, resize, crop,
                    out_hw, min_size: float = 2.0):
    """custom_pipeline.py:186-222 (_bboxes_transform)."""
    fh, fw = out_hw
    if len(bboxes) == 0:
        return bboxes, centers2d, labels, depths
    b = bboxes * resize
    b[:, [0, 2]] -= crop[0]
    b[:, [1, 3]] -= crop[1]
    b[:, [0, 2]] = np.clip(b[:, [0, 2]], 0, fw)
    b[:, [1, 3]] = np.clip(b[:, [1, 3]], 0, fh)
    keep = ((b[:, 2] - b[:, 0]) >= min_size) & ((b[:, 3] - b[:, 1]) >= min_size)
    c = centers2d * resize
    c[:, 0] = np.clip(c[:, 0] - crop[0], 0, fw)
    c[:, 1] = np.clip(c[:, 1] - crop[1], 0, fh)
    return b[keep], c[keep], labels[keep], depths[keep]


def filter_invisible(bboxes, centers2d, labels, depths, out_hw):
    """Occlusion filter (custom_pipeline.py:243-267): paint far-to-near box
    indices; keep only boxes still visible somewhere."""
    if len(bboxes) == 0:
        return bboxes, centers2d, labels, depths
    fh, fw = out_hw
    order = np.argsort(-depths, kind='stable')
    bboxes, centers2d = bboxes[order], centers2d[order]
    labels, depths = labels[order], depths[order]
    imap = np.zeros((fh, fw), np.int64)
    tmp = np.zeros_like(bboxes)
    tmp[:, :2] = np.ceil(bboxes[:, :2])
    tmp[:, 2:] = np.floor(bboxes[:, 2:])
    tmp = tmp.astype(np.int64)
    for i, (u1, v1, u2, v2) in enumerate(tmp):
        imap[v1:v2, u1:u2] = i
    vis = np.unique(imap).astype(np.int64)
    return bboxes[vis], centers2d[vis], labels[vis], depths[vis]


def paint_instance_depth(bboxes, depths, hw8, depth_cfg: DepthNetConfig):
    """AV2DownsampleQuantizeInstanceDepthmap (custom_pipeline.py:445-537):
    paint box rectangles with center depth on the stride-8 grid (annotation
    order is far-to-near already after filter_invisible's sort), LID-bin."""
    h8, w8 = hw8
    dm = np.zeros((h8, w8), np.float32)
    fg = np.zeros((h8, w8), bool)
    if len(bboxes):
        bb = bboxes / depth_cfg.stride
        bb[:, :2] = np.floor(bb[:, :2])
        bb[:, 2:] = np.ceil(bb[:, 2:])
        bb = bb.astype(np.int64)
        for (u1, v1, u2, v2), d in zip(bb, depths):
            dm[v1:v2, u1:u2] = d
            fg[v1:v2, u1:u2] = True
    bs = 2 * (depth_cfg.depth_max - depth_cfg.depth_min) / (
        depth_cfg.num_depth_bins * (1 + depth_cfg.num_depth_bins))
    with np.errstate(invalid='ignore'):
        idx = -0.5 + 0.5 * np.sqrt(1 + 8 * (dm - depth_cfg.depth_min) / bs)
    bad = (idx < 0) | (idx > depth_cfg.num_depth_bins) | ~np.isfinite(idx)
    idx[bad] = depth_cfg.num_depth_bins
    return idx.astype(np.int32), fg


def process_frame(rec: Dict, cfg: Far3DConfig,
                  rng: Optional[np.random.Generator] = None,
                  train: bool = True,
                  images: Optional[List[np.ndarray]] = None) -> Dict:
    """Full per-frame host pipeline -> static-shape numpy arrays.

    `images` may be passed pre-loaded (testing); otherwise loaded from
    rec['img_paths']."""
    rng = rng or np.random.default_rng(0)
    dc = cfg.data
    fh, fw = dc.input_hw
    mean = np.asarray(dc.img_mean, np.float32)
    n = len(rec['img_paths']) if images is None else len(images)

    # uint8 canvas: 4x less host->device traffic than f32; normalization
    # happens on device (Far3D handles uint8 input). Pad pixels carry the
    # rounded channel mean, which normalizes to ~0.005 — within the uint8
    # interpolation rounding already present (reference pads exact 0.0
    # post-normalize; deviation is sub-noise).
    pad_bgr = np.rint(mean).astype(np.uint8)
    imgs_out = np.empty((n, fh, fw, 3), np.uint8)
    imgs_out[:] = pad_bgr
    intr = rec['intrinsics'].astype(np.float64).copy()
    has_gt = 'gt_bboxes_2d' in rec and not train is None
    g2 = dc.max_gt_2d
    h8, w8 = fh // cfg.depthnet.stride, fw // cfg.depthnet.stride
    boxes2d = np.zeros((n, g2, 4), np.float32)
    labels2d = np.zeros((n, g2), np.int64)
    centers2d = np.zeros((n, g2, 2), np.float32)
    mask2d = np.zeros((n, g2), bool)
    depth_bins = np.full((n, h8 * w8), cfg.depthnet.num_depth_bins, np.int32)
    depth_fg = np.zeros((n, h8 * w8), bool)

    for i in range(n):
        img = images[i] if images is not None else read_image(
            rec['img_paths'][i])
        h, w = img.shape[:2]
        ida = np.eye(3)
        pix = np.eye(3)          # final-canvas -> source pixel-center map
        gb = gl = gc = gd = None
        if 'gt_bboxes_2d' in rec:
            gb = rec['gt_bboxes_2d'][i].copy()
            gl = rec['gt_labels_2d'][i].copy()
            gc = rec['gt_centers_2d'][i].copy()
            gd = rec['gt_depths_2d'][i].copy()
        if h > w:  # portrait front camera: landscape it first
            resize, dims, crop = sample_augmentation_front(h, w)
            ida = ida_matrix(resize, crop) @ ida
            pix = pix @ _pix_map((h, w), dims, crop)
            out_hw = (crop[3] - crop[1], crop[2] - crop[0])
            if gb is not None and len(gb):
                gb, gc, gl, gd = transform_boxes(
                    gb, gc, gl, gd, resize, crop, out_hw)
            h, w = out_hw
        resize, dims, crop = sample_augmentation(rng, dc, h, w, train)
        ida = ida_matrix(resize, crop) @ ida
        pix = pix @ _pix_map((h, w), dims, crop)
        out_hw = (crop[3] - crop[1], crop[2] - crop[0])
        if gb is not None and len(gb):
            gb, gc, gl, gd = transform_boxes(gb, gc, gl, gd, resize, crop,
                                             out_hw)
            gb, gc, gl, gd = filter_invisible(gb, gc, gl, gd, out_hw)
        intr[i][:3, :3] = ida @ intr[i][:3, :3]
        # one resampling pass straight onto the padded canvas (the composed
        # map replaces the reference's chain of full-resolution float
        # resizes, custom_pipeline.py:71-111 — measured 10x host speedup)
        if img.dtype != np.uint8:   # test paths may inject float images
            img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
        warped = warp_affine_inverse(img, pix[:2], (fw, fh))
        ih, iw = min(out_hw[0], fh), min(out_hw[1], fw)
        warped[ih:] = pad_bgr
        warped[:, iw:] = pad_bgr
        imgs_out[i] = warped

        if gb is not None:
            m = min(len(gb), g2)
            boxes2d[i, :m] = gb[:m]
            labels2d[i, :m] = gl[:m]
            centers2d[i, :m] = gc[:m]
            mask2d[i, :m] = True
            db, df = paint_instance_depth(gb, gd, (h8, w8), cfg.depthnet)
            depth_bins[i] = db.reshape(-1)
            depth_fg[i] = df.reshape(-1)

    # updated lidar2img from the ida-adjusted intrinsics (custom_pipeline:173)
    lidar2img = np.einsum('nij,njk->nik', intr, rec['extrinsics'].astype(
        np.float64)).astype(np.float32)

    out = dict(
        images=imgs_out,
        lidar2img=lidar2img,
        intrinsics=intr.astype(np.float32),
        extrinsics=rec['extrinsics'].astype(np.float32),
        timestamp=np.float32(rec['timestamp']),
        prev_exists=np.float32(rec['prev_exists']),
        ego_pose=rec['ego_pose'].astype(np.float32),
        ego_pose_inv=rec['ego_pose_inv'].astype(np.float32),
        scene_token=rec['scene_token'],
        lidar_timestamp=rec.get('lidar_timestamp', 0),
    )
    if 'gt_boxes_3d' in rec:
        g = dc.max_gt
        gt3 = np.zeros((g, 7), np.float32)
        gv3 = np.zeros((g, 2), np.float32)
        gl3 = np.zeros((g,), np.int64)
        gm3 = np.zeros((g,), bool)
        # range filter (ObjectRangeFilter, far3d.py:179)
        b3 = rec['gt_boxes_3d']
        l3 = rec['gt_labels_3d']
        v3 = np.asarray(rec.get('gt_velocity',
                                np.zeros((len(b3), 2))), np.float32)
        pcr = np.asarray(cfg.pc_range)
        inr = ((b3[:, 0] >= pcr[0]) & (b3[:, 0] <= pcr[3]) &
               (b3[:, 1] >= pcr[1]) & (b3[:, 1] <= pcr[4]))
        b3, l3, v3 = b3[inr], l3[inr], v3[inr]
        m = min(len(b3), g)
        gt3[:m] = b3[:m, :7]
        gv3[:m] = v3[:m]
        gl3[:m] = l3[:m]
        gm3[:m] = True
        out.update(gt_boxes=gt3, gt_velocity=gv3, gt_labels=gl3, gt_mask=gm3,
                   gt_boxes2d=boxes2d, gt_labels2d=labels2d,
                   gt_centers2d=centers2d, gt_mask2d=mask2d,
                   gt_depth_bins=depth_bins, gt_depth_fg=depth_fg)
    return out
