"""Typed configuration for the PyTorch port of Far3D.

A copy of the dataclasses of the JAX package's ``far3d_tpu/config.py``, kept
here so that the port never imports that package. Field names and defaults are
the same. ``DeformableAggConfig.use_pallas`` is gone: the port picks the MSDA
implementation from the device of the tensors it is given (``ops/msda.py``).

As in the JAX package, the reference's dynamic proposal and denoising counts
are static budgets plus validity masks (``num_proposals_2d``, ``dn_groups``,
``dn_max_gt``, ``max_gt``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


# AV2 26-class taxonomy (projects/configs/far3d.py:15-20).
AV2_CLASS_NAMES: Tuple[str, ...] = (
    'ARTICULATED_BUS', 'BICYCLE', 'BICYCLIST', 'BOLLARD', 'BOX_TRUCK', 'BUS',
    'CONSTRUCTION_BARREL', 'CONSTRUCTION_CONE', 'DOG', 'LARGE_VEHICLE',
    'MESSAGE_BOARD_TRAILER', 'MOBILE_PEDESTRIAN_CROSSING_SIGN', 'MOTORCYCLE',
    'MOTORCYCLIST', 'PEDESTRIAN', 'REGULAR_VEHICLE', 'SCHOOL_BUS', 'SIGN',
    'STOP_SIGN', 'STROLLER', 'TRUCK', 'TRUCK_CAB', 'VEHICULAR_TRAILER',
    'WHEELCHAIR', 'WHEELED_DEVICE', 'WHEELED_RIDER',
)

# Long-range point-cloud range, ±152.4 m (projects/configs/far3d.py:10).
PC_RANGE: Tuple[float, ...] = (-152.4, -152.4, -5.0, 152.4, 152.4, 5.0)

# BGR mean/std, to_rgb=False (projects/configs/far3d.py:13-14).
IMG_MEAN: Tuple[float, ...] = (103.530, 116.280, 123.675)
IMG_STD: Tuple[float, ...] = (57.375, 57.120, 58.395)


@dataclasses.dataclass(frozen=True)
class DepthNetConfig:
    """Categorical depth net (far3d.py:31 `depthnet_config`)."""
    hidden_dim: int = 256
    num_depth_bins: int = 50
    depth_min: float = 1e-1
    depth_max: float = 110.0
    stride: int = 8          # predicted on the stride-8 FPN level
    conv_layers: int = 2


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """VoVNet-99-eSE spec (vovnet.py:79-87)."""
    stem_channels: Tuple[int, ...] = (64, 64, 128)
    stage_conv_channels: Tuple[int, ...] = (128, 160, 192, 224)
    stage_out_channels: Tuple[int, ...] = (256, 512, 768, 1024)
    layers_per_block: int = 5
    blocks_per_stage: Tuple[int, ...] = (1, 3, 9, 3)
    # which stage outputs to return (stage2..stage5 == strides 4/8/16/32)
    out_stages: Tuple[int, ...] = (2, 3, 4, 5)
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class NeckConfig:
    """FPN (far3d.py:50-57): start_level=1, extra conv on output, 4 outs."""
    in_channels: Tuple[int, ...] = (256, 512, 768, 1024)
    out_channels: int = 256
    start_level: int = 1
    num_outs: int = 4
    relu_before_extra_convs: bool = True


@dataclasses.dataclass(frozen=True)
class Yolox2DConfig:
    """2D prior head (far3d.py:58-74, yolox_head.py)."""
    num_classes: int = 26
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 2
    strides: Tuple[int, ...] = (8, 16, 32, 64)
    threshold_score: float = 0.1      # proposal score threshold (yolox_head.py:151)
    # static per-sample top-K over all cams x levels, masked by score > threshold
    num_proposals_2d: int = 256
    center_radius: float = 2.5
    candidate_topk: int = 10
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 5.0
    loss_obj_weight: float = 1.0
    loss_l1_weight: float = 1.0
    loss_centers2d_weight: float = 1.0
    loss_depth_weight: float = 1.0
    ddn_fg_weight: float = 13.0
    ddn_bg_weight: float = 1.0
    ddn_alpha: float = 0.25
    ddn_gamma: float = 2.0


@dataclasses.dataclass(frozen=True)
class DeformableAggConfig:
    """Perspective-aware aggregation (detr3d_transformer.py:483-569)."""
    embed_dims: int = 256
    num_groups: int = 8
    num_levels: int = 4
    num_cams: int = 7
    num_pts: int = 13
    dropout: float = 0.1
    offset_init_bias: float = 2.0   # `bias=2.` in config


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Detr3D temporal decoder (far3d.py:102-132)."""
    embed_dims: int = 256
    num_layers: int = 6
    num_heads: int = 8
    ffn_dims: int = 2048
    dropout: float = 0.1
    attn_dropout: float = 0.1
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class MultiDepthConfig:
    """Multi-depth proposal lifting (far3d.py:97 `multi_depth_config`)."""
    topk: int = 1
    range_min: float = 30.0


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """FarHead (far3d.py:75-159)."""
    num_classes: int = 26
    embed_dims: int = 256
    num_query: int = 644
    memory_len: int = 1024
    topk_proposals: int = 256       # propagated top-k each frame
    num_propagated: int = 256
    with_ego_pos: bool = True
    add_query_from_2d: bool = True
    return_context_feat: bool = True
    return_bbox2d_scores: bool = True
    code_size: int = 8
    code_weights: Tuple[float, ...] = (1.0,) * 8
    # denoising budgets (training only; the port's inference path has no DN)
    with_dn: bool = True
    dn_groups: int = 10
    dn_max_gt: int = 20
    num_smp_per_gt: int = 3
    dn_noise_scale: float = 1.0
    dn_noise_trans: float = 0.0
    dn_offset: float = 0.5
    dn_offset_p: float = 0.0
    dn_weight: float = 1.0
    multi_depth: MultiDepthConfig = MultiDepthConfig()
    train_use_gt_depth: bool = True
    val_use_gt_depth: bool = False
    loss_cls_weight: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    loss_bbox_weight: float = 0.25
    sync_cls_avg_factor: bool = False
    # decode (NMSFreeCoder, far3d.py:133-139)
    max_decode_num: int = 300
    post_center_range: Tuple[float, ...] = PC_RANGE


@dataclasses.dataclass(frozen=True)
class DataConfig:
    num_cams: int = 7
    # final padded input size H x W
    input_hw: Tuple[int, int] = (640, 960)
    resize_lim: Tuple[float, float] = (0.47, 0.55)
    final_dim_f: Tuple[int, int] = (640, 720)
    img_mean: Tuple[float, ...] = IMG_MEAN
    img_std: Tuple[float, ...] = IMG_STD
    max_gt: int = 160
    max_gt_2d: int = 96
    queue_length: int = 1
    seq_split_num: int = 2


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-4
    backbone_lr_mult: float = 0.1
    layer_decay: float = 1.0
    weight_decay: float = 0.01
    grad_clip_norm: float = 35.0
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3
    min_lr_ratio: float = 1e-3
    total_iters: int = 82548
    use_gt_depth_until_iter: int = 22000
    grid_mask_prob: float = 0.7
    use_grid_mask: bool = True
    dtype: str = 'bfloat16'
    ema_decay: float = 0.0
    checkpoint_every: int = 13758
    keep_checkpoints: int = 1
    log_every: int = 50
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Far3DConfig:
    """Everything needed to build and run the detector (mirrors far3d.py)."""
    num_classes: int = 26
    pc_range: Tuple[float, ...] = PC_RANGE
    strides: Tuple[int, ...] = (8, 16, 32, 64)
    backbone: BackboneConfig = BackboneConfig()
    neck: NeckConfig = NeckConfig()
    roi2d: Yolox2DConfig = Yolox2DConfig()
    depthnet: DepthNetConfig = DepthNetConfig()
    head: HeadConfig = HeadConfig()
    deform: DeformableAggConfig = DeformableAggConfig()
    decoder: DecoderConfig = DecoderConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()

    @property
    def class_names(self) -> Sequence[str]:
        return AV2_CLASS_NAMES

    def replace(self, **kw) -> 'Far3DConfig':
        return dataclasses.replace(self, **kw)


def apply_overrides(cfg: Far3DConfig, overrides: Sequence[str]) -> Far3DConfig:
    """Dotted-path config overrides — the `--cfg-options` equivalent
    (reference tools/train.py:64-73 DictAction deep-merge).

    Each override is 'a.b.c=value'; value is parsed as a Python literal when
    possible (ints, floats, bools, tuples), else kept as a string. Nested
    dataclasses are rebuilt immutably. Unknown fields raise with the set of
    valid names.
    """
    import ast

    def set_path(node, path, value):
        field = path[0]
        names = {f.name for f in dataclasses.fields(node)}
        if field not in names:
            raise KeyError(
                f'unknown config field {field!r} on {type(node).__name__}; '
                f'valid: {sorted(names)}')
        if len(path) == 1:
            old = getattr(node, field)
            if old is not None and not isinstance(old, (str, type(None))) \
                    and isinstance(value, str):
                raise TypeError(
                    f'{".".join(path)}: could not parse {value!r} as a '
                    f'literal for field of type {type(old).__name__}')
            if isinstance(old, tuple) and isinstance(value, list):
                value = tuple(value)
            if isinstance(old, float) and isinstance(value, int):
                value = float(value)
            return dataclasses.replace(node, **{field: value})
        return dataclasses.replace(
            node, **{field: set_path(getattr(node, field), path[1:], value)})

    for ov in overrides or ():
        if '=' not in ov:
            raise ValueError(f'override must be key=value, got {ov!r}')
        key, raw = ov.split('=', 1)
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        cfg = set_path(cfg, key.strip().split('.'), value)
    return cfg


def tiny_test_config() -> Far3DConfig:
    """A scaled-down config for fast unit tests (CPU-sized shapes); the same
    shapes as the JAX package's ``tiny_test_config``."""
    return Far3DConfig(
        pc_range=(-10.0, -10.0, 0.5, 10.0, 10.0, 12.0),
        backbone=BackboneConfig(
            stem_channels=(8, 8, 16),
            stage_conv_channels=(8, 8, 8, 8),
            stage_out_channels=(16, 24, 32, 48),
            layers_per_block=2,
            blocks_per_stage=(1, 1, 1, 1),
            remat=False,
        ),
        neck=NeckConfig(in_channels=(16, 24, 32, 48), out_channels=64),
        roi2d=Yolox2DConfig(in_channels=64, feat_channels=64, num_proposals_2d=8,
                            stacked_convs=1),
        depthnet=DepthNetConfig(hidden_dim=64, num_depth_bins=10),
        head=HeadConfig(embed_dims=64, num_query=24, memory_len=32,
                        topk_proposals=8, num_propagated=8,
                        dn_groups=2, dn_max_gt=4, max_decode_num=16),
        deform=DeformableAggConfig(embed_dims=64, num_groups=4, num_cams=2),
        decoder=DecoderConfig(embed_dims=64, num_layers=2, num_heads=4,
                              ffn_dims=128, remat=False),
        data=DataConfig(num_cams=2, input_hw=(64, 96), max_gt=8, max_gt_2d=8),
    )
