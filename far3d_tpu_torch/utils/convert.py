"""Weights for the port: the reference checkpoint's key layout, random
reference-keyed weights, and the JAX package's parameters carried across.

The port's parameter names are the reference checkpoint's state-dict keys, so
a reference checkpoint loads with ``load_state_dict`` directly. The mapping
between those keys and the JAX package's flax variable tree is a copy of
``_build_mapping`` and the layout transforms of
``far3d_tpu/utils/torch_convert.py``; ``from_jax_variables`` runs it backwards.
StreamPETR has no reference checkpoint here: its port names are the flax
tree's below the shared backbone and neck, and ``petr_from_jax_variables``
carries the JAX package's StreamPETR variables across.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


Mapping = List[Tuple[Tuple[str, ...], str, str]]


def _conv_bn(m: Mapping, our_prefix: Tuple[str, ...], ref_prefix: str,
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


def _linear(m: Mapping, our_prefix: Tuple[str, ...], ref_prefix: str,
            kind: str = 'lin'):
    m.append((('params',) + our_prefix + ('kernel',),
              ref_prefix + '.weight', kind))
    m.append((('params',) + our_prefix + ('bias',),
              ref_prefix + '.bias', 'flat' if kind == 'heads_in' else 'copy'))


def _conv2d(m: Mapping, our_prefix: Tuple[str, ...], ref_prefix: str,
            bias: bool = True):
    m.append((('params',) + our_prefix + ('kernel',),
              ref_prefix + '.weight', 'conv'))
    if bias:
        m.append((('params',) + our_prefix + ('bias',),
                  ref_prefix + '.bias', 'copy'))


def _layernorm(m: Mapping, our_prefix: Tuple[str, ...], ref_prefix: str):
    m.append((('params',) + our_prefix + ('scale',),
              ref_prefix + '.weight', 'copy'))
    m.append((('params',) + our_prefix + ('bias',),
              ref_prefix + '.bias', 'copy'))


def _backbone_neck_mapping(cfg, m: Mapping) -> None:
    """The VoVNet (vovnet.py naming) and the mmdet FPN, shared by Far3D and
    StreamPETR."""
    for k in (1, 2, 3):
        _conv_bn(m, ('backbone', f'stem{k}'), f'img_backbone.stem.stem_{k}')
    for si, nblocks in enumerate(cfg.backbone.blocks_per_stage):
        s = si + 2
        for b in range(nblocks):
            ours = ('backbone', f'stage{s}_block{b}')
            ref = f'img_backbone.stage{s}.OSA{s}_{b + 1}'
            for i in range(cfg.backbone.layers_per_block):
                _conv_bn(m, ours + (f'layer{i}',),
                         f'{ref}.layers.{i}.OSA{s}_{b + 1}_{i}')
            _conv_bn(m, ours + ('concat',),
                     f'{ref}.concat.OSA{s}_{b + 1}_concat')
            _conv2d(m, ours + ('ese', 'fc'), f'{ref}.ese.fc')
    n_used = len(cfg.neck.in_channels) - cfg.neck.start_level
    for i in range(n_used):
        _conv2d(m, ('neck', f'lateral{i}'), f'img_neck.lateral_convs.{i}.conv')
    for i in range(cfg.neck.num_outs):
        _conv2d(m, ('neck', f'fpn{i}'), f'img_neck.fpn_convs.{i}.conv')


def _build_mapping(cfg) -> Mapping:
    """[(flax path (collection, *keys), reference key, kind)] of Far3D."""
    m: Mapping = []

    def linear(our_prefix, ref_prefix):
        _linear(m, our_prefix, ref_prefix)

    def conv2d(our_prefix, ref_prefix, bias=True):
        _conv2d(m, our_prefix, ref_prefix, bias)

    def layernorm(our_prefix, ref_prefix):
        _layernorm(m, our_prefix, ref_prefix)

    _backbone_neck_mapping(cfg, m)

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


def _petr_mapping(cfg) -> Mapping:
    """[(flax path, port key, kind)] of StreamPETR: the backbone and neck
    under Far3D's names, the head ``pts_bbox_head`` under the flax tree's
    (``pts_head``) names. A flax ``DenseGeneral`` into heads (C, H, D) is a
    torch ``Linear`` (H*D, C), its (H, D) bias flat; one out of heads
    (H, D, C) is a ``Linear`` (C, H*D)."""
    m: Mapping = []
    _backbone_neck_mapping(cfg, m)
    F, P = ('pts_head',), 'pts_bbox_head'
    _conv2d(m, F + ('input_proj',), f'{P}.input_proj')
    _linear(m, F + ('pe', 'pe_fc1'), f'{P}.pe.pe_fc1')
    _linear(m, F + ('pe', 'pe_fc2'), f'{P}.pe.pe_fc2')
    for name in ('reference_points', 'pseudo_reference_points'):
        m.append((('params',) + F + (name,), f'{P}.{name}', 'copy'))
    _linear(m, F + ('query_embedding', 'dense0'), f'{P}.query_embedding.0')
    _linear(m, F + ('query_embedding', 'dense1'), f'{P}.query_embedding.2')
    if cfg.with_ego_pos:
        for mln in ('ego_pose_pe', 'ego_pose_memory'):
            _linear(m, F + (mln, 'reduce'), f'{P}.{mln}.reduce.0')
            _linear(m, F + (mln, 'gamma'), f'{P}.{mln}.gamma')
            _linear(m, F + (mln, 'beta'), f'{P}.{mln}.beta')
    _linear(m, F + ('time_fc',), f'{P}.time_fc')
    _layernorm(m, F + ('time_ln',), f'{P}.time_ln')
    for name in ('cls_fc0', 'cls_fc1', 'cls_out', 'reg_fc0', 'reg_fc1',
                 'reg_out'):
        _linear(m, F + (name,), f'{P}.{name}')
    for name in ('cls_ln0', 'cls_ln1'):
        _layernorm(m, F + (name,), f'{P}.{name}')
    for i in range(cfg.num_layers):
        L, R = F + ('decoder', f'layer{i}'), f'{P}.decoder.layer{i}'
        for attn, parts, out in (
                ('self_attn', ('query', 'key', 'value'), 'out'),
                ('cross_attn', ('q_proj', 'k_proj', 'v_proj'), 'out_proj')):
            for part in parts:
                _linear(m, L + (attn, part), f'{R}.{attn}.{part}', 'heads_in')
            _linear(m, L + (attn, out), f'{R}.{attn}.{out}', 'mha_out_w')
        for ni in range(3):
            _layernorm(m, L + (f'norm{ni}',), f'{R}.norm{ni}')
        _linear(m, L + ('ffn', 'fc1'), f'{R}.ffn.layers.0.0')
        _linear(m, L + ('ffn', 'fc2'), f'{R}.ffn.layers.1')
    return m


def petr_from_jax_variables(variables: Dict[str, Any],
                            cfg) -> Dict[str, torch.Tensor]:
    """The JAX package's StreamPETR variables (numpy leaves: 'params' and
    the backbone's 'stats') -> the port's state dict (f32 CPU tensors)."""
    out = {}
    for path, key, kind in _petr_mapping(cfg):
        node = variables
        for k in path:
            node = node[k]
        out[key] = torch.from_numpy(np.array(
            _to_reference(np.asarray(node, np.float32), kind)))
    return out


def petr_key_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """The port's StreamPETR state-dict keys and shapes, in the mapping's
    order, read off the model built on the meta device."""
    from ..models.streampetr import StreamPETR
    with torch.device('meta'):
        sd = StreamPETR(cfg).state_dict()
    return {key: tuple(sd[key].shape) for _, key, _ in _petr_mapping(cfg)}


def random_petr_state_dict(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random StreamPETR weights, fan-in scaled as
    ``random_reference_state_dict``'s, for the full-width runs."""
    return _random_weights(petr_key_shapes(cfg), np.random.default_rng(seed))


def petr_init_state_dict(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """StreamPETR's initial weights for training from scratch, from the
    flax initializers of the JAX model (in distribution; the draws differ):
    lecun-normal kernels (fan-in the input features, as flax's
    ``DenseGeneral`` counts them) and zero biases, norm scales 1 and biases
    0, BN statistics 0 and 1, reference points U(0, 1), the MLN's
    zero-kernel ``gamma`` (bias 1) and ``beta``, and the focal prior
    -log(99) of ``cls_out``'s bias (streampetr.py:182-193)."""
    rng = np.random.default_rng(seed)
    prior = -float(np.log((1 - 0.01) / 0.01))
    sd: Dict[str, np.ndarray] = {}
    for key, s in petr_key_shapes(cfg).items():
        module = key.rsplit('.', 2)[-2] if key.count('.') >= 1 else ''
        if key.endswith('running_mean'):
            v = np.zeros(s)
        elif key.endswith('running_var'):
            v = np.ones(s)
        elif key.endswith('reference_points'):
            v = rng.uniform(0.0, 1.0, s)
        elif module in ('gamma', 'beta'):
            v = np.ones(s) if key.endswith('gamma.bias') else np.zeros(s)
        elif key.endswith('.weight') and len(s) == 1:
            v = np.ones(s)
        elif key.endswith('.weight'):
            v = _truncated_normal(rng, s, np.sqrt(1.0 / int(np.prod(s[1:]))))
        elif key.endswith('cls_out.bias'):
            v = np.full(s, prior)
        else:
            v = np.zeros(s)
        sd[key] = v.astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


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
    if kind == 'heads_in':                          # flax (C, heads, hd)
        return value.reshape(value.shape[0], -1).T
    if kind == 'flat':
        return value.reshape(-1)
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
    sd = {k: v.numpy() for k, v in _random_weights(
        reference_key_shapes(cfg), rng).items()}
    # steer the 2D scores so that a moderate number of proposals pass the
    # 0.1 threshold (obj ~ sigmoid(-1), cls max ~ sigmoid(0))
    for k in sd:
        if 'conv_obj' in k and k.endswith('.bias'):
            sd[k] = (rng.standard_normal(sd[k].shape) * 0.5 - 1.0
                     ).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _random_weights(shapes: Dict[str, Tuple[int, ...]],
                    rng: np.random.Generator) -> Dict[str, torch.Tensor]:
    sd = {}
    for k, s in shapes.items():
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
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _truncated_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    """N(0, 1) truncated to [-2, 2] (redrawn outside), scaled so that its
    standard deviation is `std`: flax's ``variance_scaling`` with
    'truncated_normal'."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2
    return x * (std / 0.87962566103423978)


def init_state_dict(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Reference-keyed initial weights for training from scratch, drawn from
    the JAX model's own initializers (in distribution; the draws differ):
    lecun-normal kernels and zero biases (flax's defaults), norm scales 1
    and biases 0, BN statistics 0 and 1, reference points U(0, 1), and the
    overrides of the JAX modules: the focal prior bias -log(99) of the 3D
    and 2D classifiers and the 2D objectness (farhead.py:419-421,
    heads2d.py:69-81), xavier-uniform ``learnable_fc`` with U(-b, b) bias
    b = offset_init_bias and xavier-uniform ``output_proj``
    (decoder.py:64-67,106-109), zero ``weights_fc`` (:79-82), and the MLN's
    zero-kernel ``gamma`` (bias 1) and ``beta`` (bias 0) (layers.py:92-97)."""
    rng = np.random.default_rng(seed)
    shapes = reference_key_shapes(cfg)
    prior = -float(np.log((1 - 0.01) / 0.01))
    sd: Dict[str, np.ndarray] = {}
    for path, ref_key, kind in _build_mapping(cfg):
        if ref_key in sd:                     # the MHA's packed q, k, v
            continue
        s = shapes[ref_key]
        names, leaf = path[1:-1], path[-1]
        module = names[-1] if names else ''
        if path[0] in ('stats', 'batch_stats'):
            v = np.zeros(s) if leaf == 'mean' else np.ones(s)
        elif leaf in ('reference_points', 'pseudo_reference_points'):
            v = rng.uniform(0.0, 1.0, s)
        elif leaf == 'scale':
            v = np.ones(s)
        elif leaf == 'kernel' and module in ('weights_fc', 'gamma', 'beta'):
            v = np.zeros(s)
        elif leaf == 'kernel' and module in ('learnable_fc', 'output_proj'):
            limit = np.sqrt(6.0 / (s[0] + int(np.prod(s[1:]))))
            v = rng.uniform(-limit, limit, s)
        elif leaf == 'kernel':
            v = _truncated_normal(rng, s, np.sqrt(1.0 / int(np.prod(s[1:]))))
        elif module == 'learnable_fc':
            b = cfg.deform.offset_init_bias
            v = rng.uniform(-b, b, s)
        elif module == 'gamma':
            v = np.ones(s)
        elif module == 'cls_out' or module.startswith(('conv_cls', 'conv_obj')):
            v = np.full(s, prior)
        else:
            v = np.zeros(s)
        sd[ref_key] = v.astype(np.float32)
    return {k: torch.from_numpy(sd[k]) for k in shapes}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a reference ``.pth`` (its ``state_dict`` entry when it
    has one, as mmcv writes them), on the CPU. Loaded with
    ``weights_only=True``: tensors and plain containers, no code."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = ckpt.get('state_dict', ckpt)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
