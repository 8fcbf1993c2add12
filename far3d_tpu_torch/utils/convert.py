"""Weights for the port: the reference checkpoint's key layout, random
reference-keyed weights, and the JAX package's parameters carried across.

The port's parameter names are the reference checkpoint's state-dict keys, so
a reference checkpoint loads with ``load_state_dict`` directly. The mapping
between those keys and the JAX package's flax variable tree is a copy of
``_build_mapping`` and the layout transforms of
``far3d_tpu/utils/torch_convert.py``; ``from_jax_variables`` runs it backwards.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _build_mapping(cfg) -> List[Tuple[Tuple[str, ...], str, str]]:
    """[(flax path (collection, *keys), reference key, kind)]"""
    m: List[Tuple[Tuple[str, ...], str, str]] = []

    def conv_bn(our_prefix: Tuple[str, ...], ref_prefix: str,
                stats_col: str = 'stats'):
        m.append((('params',) + our_prefix + ('conv', 'kernel'),
                  ref_prefix + '/conv.weight', 'conv'))
        m.append((('params',) + our_prefix + ('bn', 'scale'),
                  ref_prefix + '/norm.weight', 'copy'))
        m.append((('params',) + our_prefix + ('bn', 'bias'),
                  ref_prefix + '/norm.bias', 'copy'))
        m.append(((stats_col,) + our_prefix + ('bn', 'mean'),
                  ref_prefix + '/norm.running_mean', 'copy'))
        m.append(((stats_col,) + our_prefix + ('bn', 'var'),
                  ref_prefix + '/norm.running_var', 'copy'))

    def linear(our_prefix: Tuple[str, ...], ref_prefix: str):
        m.append((('params',) + our_prefix + ('kernel',),
                  ref_prefix + '.weight', 'lin'))
        m.append((('params',) + our_prefix + ('bias',),
                  ref_prefix + '.bias', 'copy'))

    def conv2d(our_prefix: Tuple[str, ...], ref_prefix: str, bias=True):
        m.append((('params',) + our_prefix + ('kernel',),
                  ref_prefix + '.weight', 'conv'))
        if bias:
            m.append((('params',) + our_prefix + ('bias',),
                      ref_prefix + '.bias', 'copy'))

    def layernorm(our_prefix: Tuple[str, ...], ref_prefix: str):
        m.append((('params',) + our_prefix + ('scale',),
                  ref_prefix + '.weight', 'copy'))
        m.append((('params',) + our_prefix + ('bias',),
                  ref_prefix + '.bias', 'copy'))

    # ---- backbone (vovnet.py naming) ----------------------------------
    for k in (1, 2, 3):
        conv_bn(('backbone', f'stem{k}'), f'img_backbone.stem.stem_{k}')
    for si, nblocks in enumerate(cfg.backbone.blocks_per_stage):
        s = si + 2
        for b in range(nblocks):
            ours = ('backbone', f'stage{s}_block{b}')
            ref = f'img_backbone.stage{s}.OSA{s}_{b + 1}'
            for i in range(cfg.backbone.layers_per_block):
                conv_bn(ours + (f'layer{i}',),
                        f'{ref}.layers.{i}.OSA{s}_{b + 1}_{i}')
            conv_bn(ours + ('concat',), f'{ref}.concat.OSA{s}_{b + 1}_concat')
            conv2d(ours + ('ese', 'fc'), f'{ref}.ese.fc')

    # ---- neck (mmdet FPN naming) ---------------------------------------
    n_used = len(cfg.neck.in_channels) - cfg.neck.start_level
    for i in range(n_used):
        conv2d(('neck', f'lateral{i}'), f'img_neck.lateral_convs.{i}.conv')
    for i in range(cfg.neck.num_outs):
        conv2d(('neck', f'fpn{i}'), f'img_neck.fpn_convs.{i}.conv')

    # ---- 2D roi head ----------------------------------------------------
    for l in range(len(cfg.roi2d.strides)):
        for s in range(cfg.roi2d.stacked_convs):
            for tower, ref_t in (('cls_tower', 'multi_level_cls_convs'),
                                 ('reg_tower', 'multi_level_reg_convs')):
                base = ('roi_head', f'{tower}{l}_{s}')
                ref = f'img_roi_head.{ref_t}.{l}.{s}'
                m.append((('params',) + base + ('conv', 'kernel'),
                          ref + '.conv.weight', 'conv'))
                m.append((('params',) + base + ('bn', 'scale'),
                          ref + '.bn.weight', 'copy'))
                m.append((('params',) + base + ('bn', 'bias'),
                          ref + '.bn.bias', 'copy'))
                m.append((('batch_stats',) + base + ('bn', 'mean'),
                          ref + '.bn.running_mean', 'copy'))
                m.append((('batch_stats',) + base + ('bn', 'var'),
                          ref + '.bn.running_var', 'copy'))
        for ours, ref in (('conv_cls', 'multi_level_conv_cls'),
                          ('conv_reg', 'multi_level_conv_reg'),
                          ('conv_obj', 'multi_level_conv_obj'),
                          ('conv_centers2d', 'multi_level_conv_centers2d')):
            conv2d(('roi_head', f'{ours}{l}'), f'img_roi_head.{ref}.{l}')
    for i in range(cfg.depthnet.conv_layers):
        conv2d(('roi_head', 'depthnet', f'conv{i}', 'conv'),
               f'img_roi_head.depthnet.depth_head.{i}.0')
        m.append((('params', 'roi_head', 'depthnet', f'conv{i}', 'gn', 'scale'),
                  f'img_roi_head.depthnet.depth_head.{i}.1.weight', 'copy'))
        m.append((('params', 'roi_head', 'depthnet', f'conv{i}', 'gn', 'bias'),
                  f'img_roi_head.depthnet.depth_head.{i}.1.bias', 'copy'))
    conv2d(('roi_head', 'depthnet', 'classifier'),
           'img_roi_head.depthnet.depth_classifier')

    # ---- FarHead ---------------------------------------------------------
    P = 'pts_bbox_head'
    m.append((('params', 'pts_head', 'reference_points'),
              f'{P}.reference_points.weight', 'copy'))
    m.append((('params', 'pts_head', 'pseudo_reference_points'),
              f'{P}.pseudo_reference_points.weight', 'copy'))
    for mln in ('spatial_alignment', 'ego_pose_pe', 'ego_pose_memory'):
        linear(('pts_head', mln, 'reduce'), f'{P}.{mln}.reduce.0')
        linear(('pts_head', mln, 'gamma'), f'{P}.{mln}.gamma')
        linear(('pts_head', mln, 'beta'), f'{P}.{mln}.beta')
    linear(('pts_head', 'query_embedding', 'dense0'), f'{P}.query_embedding.0')
    linear(('pts_head', 'query_embedding', 'dense1'), f'{P}.query_embedding.2')
    linear(('pts_head', 'context_embed', 'dense0'), f'{P}.context_embed.0')
    linear(('pts_head', 'context_embed', 'dense1'), f'{P}.context_embed.2')
    linear(('pts_head', 'time_fc'), f'{P}.time_embedding.0')
    layernorm(('pts_head', 'time_ln'), f'{P}.time_embedding.1')
    # weight-shared cls/reg branches: instance 0 (farhead.py:248-251)
    linear(('pts_head', 'cls_fc0'), f'{P}.cls_branches.0.0')
    layernorm(('pts_head', 'cls_ln0'), f'{P}.cls_branches.0.1')
    linear(('pts_head', 'cls_fc1'), f'{P}.cls_branches.0.3')
    layernorm(('pts_head', 'cls_ln1'), f'{P}.cls_branches.0.4')
    linear(('pts_head', 'cls_out'), f'{P}.cls_branches.0.6')
    linear(('pts_head', 'reg_fc0'), f'{P}.reg_branches.0.0')
    linear(('pts_head', 'reg_fc1'), f'{P}.reg_branches.0.2')
    linear(('pts_head', 'reg_out'), f'{P}.reg_branches.0.4')

    # ---- decoder layers --------------------------------------------------
    heads = cfg.decoder.num_heads
    for i in range(cfg.decoder.num_layers):
        L = ('pts_head', 'decoder', f'layer{i}')
        R = f'{P}.transformer.decoder.layers.{i}'
        for part, off in (('query', 0), ('key', 1), ('value', 2)):
            m.append((('params',) + L + ('self_attn', 'mha', part, 'kernel'),
                      f'{R}.attentions.0.attn.in_proj_weight',
                      f'mha_qkv_w{off}_{heads}'))
            m.append((('params',) + L + ('self_attn', 'mha', part, 'bias'),
                      f'{R}.attentions.0.attn.in_proj_bias',
                      f'mha_qkv_b{off}_{heads}'))
        m.append((('params',) + L + ('self_attn', 'mha', 'out', 'kernel'),
                  f'{R}.attentions.0.attn.out_proj.weight',
                  f'mha_out_w_{heads}'))
        m.append((('params',) + L + ('self_attn', 'mha', 'out', 'bias'),
                  f'{R}.attentions.0.attn.out_proj.bias', 'copy'))
        for ni in range(3):
            layernorm(L + (f'norm{ni}',), f'{R}.norms.{ni}')
        D = f'{R}.attentions.1'
        linear(L + ('cross_attn', 'weights_fc'), f'{D}.weights_fc')
        linear(L + ('cross_attn', 'output_proj'), f'{D}.output_proj')
        linear(L + ('cross_attn', 'learnable_fc'), f'{D}.learnable_fc')
        linear(L + ('cross_attn', 'cam_embed0'), f'{D}.cam_embed.0')
        linear(L + ('cross_attn', 'cam_embed1'), f'{D}.cam_embed.2')
        layernorm(L + ('cross_attn', 'cam_embed_ln'), f'{D}.cam_embed.4')
        linear(L + ('ffn', 'fc1'), f'{R}.ffns.0.layers.0.0')
        linear(L + ('ffn', 'fc2'), f'{R}.ffns.0.layers.1')
    return m


def _to_reference(value: np.ndarray, kind: str) -> np.ndarray:
    """Inverse of the JAX package's ``_transform`` for the one-to-one kinds:
    flax conv (kh, kw, I, O) -> torch (O, I, kh, kw); flax dense (I, O) ->
    torch (O, I)."""
    if kind == 'copy':
        return value
    if kind == 'conv':
        return np.transpose(value, (3, 2, 0, 1))
    if kind == 'lin':
        return np.transpose(value, (1, 0))
    if kind.startswith('mha_out_w'):
        heads, hd, c = value.shape                  # flax (heads, hd, C)
        return value.reshape(heads * hd, c).T
    raise ValueError(kind)


def from_jax_variables(variables: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """A JAX package variable tree (numpy leaves: 'params', 'stats',
    'batch_stats') -> the port's reference-keyed state dict (f32 CPU
    tensors). The MHA's per-head query/key/value projections are packed back
    into torch's ``in_proj_weight`` (3C, C) and ``in_proj_bias`` (3C,)."""
    packed: Dict[str, Dict[int, np.ndarray]] = {}
    out: Dict[str, np.ndarray] = {}
    for path, ref_key, kind in _build_mapping(cfg):
        node = variables
        for k in path:
            node = node[k]
        leaf = np.asarray(node, np.float32)
        if kind.startswith('mha_qkv_w'):
            off = int(kind[len('mha_qkv_w'):].split('_')[0])
            c = leaf.shape[0]                       # flax (C, heads, hd)
            packed.setdefault(ref_key, {})[off] = leaf.reshape(c, c).T
        elif kind.startswith('mha_qkv_b'):
            off = int(kind[len('mha_qkv_b'):].split('_')[0])
            packed.setdefault(ref_key, {})[off] = leaf.reshape(-1)
        else:
            out[ref_key] = _to_reference(leaf, kind)
    for ref_key, parts in packed.items():
        out[ref_key] = np.concatenate([parts[i] for i in range(3)], axis=0)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def reference_key_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """The reference checkpoint's keys and torch-side shapes for ``cfg``, in
    the mapping's order, read off the port's model built on the meta device."""
    from ..models.detector import Far3D
    with torch.device('meta'):
        sd = Far3D(cfg).state_dict()
    order = dict.fromkeys(ref_key for _, ref_key, _ in _build_mapping(cfg))
    return {k: tuple(sd[k].shape) for k in order}


def random_reference_state_dict(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random reference-keyed weights, fan-in scaled so that a deep
    stack stays finite (the pattern of the JAX package's composed parity
    tests). The same numpy draws feed both packages in the tests."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, s in reference_key_shapes(cfg).items():
        if 'running_var' in k:
            v = rng.uniform(0.5, 1.5, s)
        elif 'running_mean' in k:
            v = rng.standard_normal(s) * 0.1
        elif 'reference_points' in k:
            v = rng.uniform(0.0, 1.0, s)
        elif k.endswith('.weight') and len(s) == 1:
            v = rng.uniform(0.75, 1.25, s)          # norm scales
        elif k.endswith('.weight'):
            v = rng.standard_normal(s) / np.sqrt(int(np.prod(s[1:])))
        else:
            v = rng.standard_normal(s) * 0.1        # biases
        sd[k] = v.astype(np.float32)
    # steer the 2D scores so that a moderate number of proposals pass the
    # 0.1 threshold (obj ~ sigmoid(-1), cls max ~ sigmoid(0))
    for k in sd:
        if 'conv_obj' in k and k.endswith('.bias'):
            sd[k] = (rng.standard_normal(sd[k].shape) * 0.5 - 1.0
                     ).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}
