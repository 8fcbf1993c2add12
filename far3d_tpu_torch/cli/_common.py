"""Shared plumbing of the port's diagnostic and visualization tools (the twin
of ``tools/_common.py``): the common flags, the model's weights, the
dataset, one frame's model inputs."""

from __future__ import annotations

from typing import Dict


def add_common_args(p, split_flags: bool = True):
    """The JAX tools' common flags, plus --tiny (the tiny test config, for
    fixture runs) and --device (default: the CUDA card)."""
    p.add_argument('--data-root', required=True)
    p.add_argument('--ann-file', default=None)
    if split_flags:
        p.add_argument('--dataset', choices=('av2', 'nuscenes'),
                       default='av2',
                       help='dataset family (reference: Argoverse2DatasetT '
                            '/ CustomNuScenesDataset)')
    p.add_argument('--checkpoint', default=None,
                   help='work dir of cli.train (its latest checkpoint)')
    p.add_argument('--torch-checkpoint', default=None,
                   help='reference .pth to load by key')
    p.add_argument('--out-dir', default='vis')
    p.add_argument('--num-frames', type=int, default=10)
    add_device_args(p)
    return p


def add_device_args(p):
    p.add_argument('--tiny', action='store_true',
                   help='tiny test config (for fixture runs)')
    p.add_argument('--device', default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run "
                        'on the CPU)')
    return p


def tool_config(args):
    from ..config import Far3DConfig, tiny_test_config
    return tiny_test_config() if args.tiny else Far3DConfig()


def load_model(cfg, args, device):
    """Far3D on `device` with the weights of --torch-checkpoint (a reference
    .pth, by key), or of --checkpoint (the latest train state ``cli.train``
    saved there), or else seeded random weights, so that the pipeline tools
    work untrained as the JAX tools' random init does."""
    from ..entry import build_model
    from ..train.step import create_train_state
    from ..utils.checkpoint import CheckpointManager
    from ..utils.convert import load_reference_checkpoint

    model = build_model(cfg, device)
    if args.torch_checkpoint:
        model.load_state_dict(load_reference_checkpoint(args.torch_checkpoint),
                              strict=False)
    elif args.checkpoint:
        state, _ = create_train_state(cfg, model)
        if CheckpointManager(args.checkpoint).restore(state) is None:
            raise SystemExit(f'no checkpoint in {args.checkpoint}')
    return model.eval()


def build_dataset(cfg, args, split='val'):
    if getattr(args, 'dataset', 'av2') == 'nuscenes':
        from ..data.nuscenes_dataset import NuScenesSequenceDataset
        ann = args.ann_file or \
            f'{args.data_root}/nuscenes2d_temporal_infos_{split}.pkl'
        return NuScenesSequenceDataset(ann, args.data_root, seq_split_num=1)
    from ..data.av2_dataset import AV2SequenceDataset
    ann = args.ann_file or f'{args.data_root}/av2_{split}_infos.pkl'
    return AV2SequenceDataset(ann, args.data_root, split=split,
                              test_mode=False, seq_split_num=1)


MODEL_KEYS = ('images', 'lidar2img', 'intrinsics', 'extrinsics', 'timestamp',
              'prev_exists', 'ego_pose', 'ego_pose_inv')


def model_inputs(frame: Dict, device) -> Dict:
    """An ``EvalLoader`` frame's model inputs with a batch axis, on
    `device`."""
    import torch
    return {k: torch.as_tensor(frame[k])[None].to(device)
            for k in MODEL_KEYS}


def to_numpy(x):
    """A tensor's values as numpy (bf16 as f32); anything else as is."""
    import torch
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
