"""Shared set-up of the port's parity tests (tests/test_torch_port_*.py).

One seeded reference-keyed state dict (far3d_tpu_torch.utils.convert.
random_reference_state_dict) drives both packages: the JAX model takes it
through far3d_tpu.utils.torch_convert.convert_state_dict, the port through
load_state_dict. The configuration is the tiny test config with enough 2D
proposal slots and the multi-depth topk=2 lifting, as in
tests/test_composed_parity.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import far3d_tpu.config as jcfg
import far3d_tpu_torch.config as tcfg
from far3d_tpu.models.detector import Far3D as JaxFar3D
from far3d_tpu.models.farhead import init_state as jax_init_state
from far3d_tpu.utils.torch_convert import convert_state_dict
from far3d_tpu_torch.models.detector import Far3D as TorchFar3D
from far3d_tpu_torch.utils.convert import random_reference_state_dict

TOL = dict(rtol=1e-3, atol=2e-3)


def _widen(mod, cfg):
    return dataclasses.replace(
        cfg,
        roi2d=dataclasses.replace(cfg.roi2d, num_proposals_2d=64),
        head=dataclasses.replace(
            cfg.head, multi_depth=mod.MultiDepthConfig(topk=2, range_min=30.0)))


def _without_use_pallas(tree):
    if isinstance(tree, dict):
        return {k: _without_use_pallas(v) for k, v in tree.items()
                if k != 'use_pallas'}
    return tree


def make_cfgs():
    """(JAX config, port config) with equal shapes. Checks first that the
    port's hand copy of the config keeps every default of the JAX package's,
    at full width and at the tiny test size (minus use_pallas: the port routes
    by the tensor's device)."""
    for name in ('Far3DConfig', 'tiny_test_config'):
        want = _without_use_pallas(dataclasses.asdict(getattr(jcfg, name)()))
        got = dataclasses.asdict(getattr(tcfg, name)())
        assert got == want, f'far3d_tpu_torch.config.{name}() drifted'
    return _widen(jcfg, jcfg.tiny_test_config()), \
        _widen(tcfg, tcfg.tiny_test_config())


def jax_variable_template(cfg):
    """The JAX model's variable tree as numpy zeros (shapes only: no init
    compile)."""
    b, n = 1, cfg.data.num_cams
    h, w = cfg.data.input_hw
    eye = jnp.tile(jnp.eye(4)[None, None], (b, n, 1, 1))
    shapes = jax.eval_shape(
        functools.partial(JaxFar3D(cfg).init, jax.random.PRNGKey(0)),
        images=jnp.zeros((b, n, h, w, 3)), lidar2img=eye, intrinsics=eye,
        extrinsics=eye, state=jax_init_state(b, cfg.head),
        prev_exists=jnp.zeros((b,)), timestamp=jnp.zeros((b,)),
        ego_pose=jnp.eye(4)[None], ego_pose_inv=jnp.eye(4)[None])
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def shared_weights(jax_cfg, port_cfg, seed=0):
    """-> (JAX variables, port state dict) holding the same weights."""
    sd = random_reference_state_dict(port_cfg, seed)
    converted, missing = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jax_cfg,
        jax_variable_template(jax_cfg))
    assert not missing, missing[:5]
    return jax.tree_util.tree_map(jnp.asarray, converted), sd


def port_model(port_cfg, sd):
    model = TorchFar3D(port_cfg)
    model.load_state_dict(sd)
    return model.eval()


def se3(yaw, t):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = np.cos(yaw)
    m[0, 1], m[1, 0] = -np.sin(yaw), np.sin(yaw)
    m[:3, 3] = t
    return m


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def to_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
