"""How the benchmark drives one model family, on either side: the program
(``far3d_tpu_torch``) or the reference (``portbench/reference``). A
configuration names its family (``"family"`` in its file); the family is
``portbench/families/<family>.py``, which defines ``Family``."""

from __future__ import annotations

import importlib
import importlib.util
from typing import Dict

import torch

from . import spec, traffic as tr
from .weights import seeded_weights, state_shapes


def load(config: Dict, side: str):
    """The family of configuration file `config` for `side` ('port' or
    'reference')."""
    name = spec.check_name(config['family'])
    path = spec.BENCH_DIR / 'families' / f'{name}.py'
    if not path.is_file():
        raise spec.SpecError(f'no family {path}')
    mod_spec = importlib.util.spec_from_file_location(
        f'portbench_family_{name}', path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.Family(config['model'], side)


class Base:
    """What both families share. Subclasses set the module names and the
    few calls that differ."""

    config_module = ''     # dotted module of the config dataclass
    config_class = ''
    model_module = ''
    model_class = ''

    def __init__(self, model_json: Dict, side: str):
        if side not in ('port', 'reference'):
            raise ValueError(side)
        self.side = side
        self.pkg = 'far3d_tpu_torch' if side == 'port' else 'reference'
        cfg_cls = getattr(self.mod(self.config_module), self.config_class)
        self.cfg = spec.build_dataclass(cfg_cls, model_json)

    def mod(self, name: str):
        return importlib.import_module(f'{self.pkg}.{name}')

    @property
    def model_cls(self):
        return getattr(self.mod(self.model_module), self.model_class)

    def weights(self, seed: int, device) -> Dict[str, torch.Tensor]:
        return seeded_weights(state_shapes(self.model_cls, self.cfg),
                              tr.sub_seed(seed, 0), device)

    def build(self, weights: Dict[str, torch.Tensor], device):
        """The model on `device` holding `weights`, in eval mode."""
        with torch.device('meta'):
            model = self.model_cls(self.cfg)
        model = model.to_empty(device=device)
        model.load_state_dict(weights)
        return model.eval()

    def rig(self, device) -> Dict[str, torch.Tensor]:
        r = tr.rig(self.num_cams, self.input_hw)
        return {k: torch.from_numpy(v).to(device) for k, v in r.items()
                if k in self.rig_keys}

    def state_to(self, state):
        """The other side's temporal state as this side's dataclass."""
        cls = self.mod('models.farhead').TemporalState
        return cls(**{k: getattr(state, k) for k in
                      ('embedding', 'ref_points', 'timestamp', 'egopose',
                       'velo')})

    @torch.inference_mode()
    def forward(self, model, state, batch, quant_tree=None):
        """The model's raw outputs for one frame: (last-layer logits (Q,
        classes), boxes code (Q, code), query validity (Q,), new state)."""
        out = model(state=state, quant_backbone=quant_tree,
                    **{k: batch[k] for k in self.batch_keys})
        return (out['all_cls_scores'][-1][0], out['all_bbox_preds'][-1][0],
                out['query_valid'][0], out['state'])

    batch_keys = ('images', 'lidar2img', 'prev_exists', 'timestamp',
                  'ego_pose', 'ego_pose_inv')
    rig_keys = ('lidar2img',)
