"""The port's int8 serving backbone (far3d_tpu_torch/ops/quant.py,
ops/qconv.py) against the JAX package's ops/quant.py, on the CPU at the tiny
size, the weights shared through the reference-keyed state dict.

* ``build_quant_vovnet``: from the same amax, every leaf of the tree (int8
  weights, f32 multipliers, eSE weights, scalars) is bitwise the JAX one's.
* ``calibrate_vovnet``: the amax of every site within rtol 1e-2 of JAX's
  (a max over bf16 activations of two bf16 backbones).
* ``quant_vovnet_forward``: from the same tree and input, the int8
  activations after every conv of the stem and every OSA block equal the JAX
  ones on at least 99.9% of elements and differ by at most 1 elsewhere (a
  rounding tie may fall the other way where XLA's CPU epilogue contracts the
  multiply and the add, or sums the eSE mean in another order); the bf16
  stage outputs agree within 2 quanta of each stage's scale.
* ``qconv_reference``: the s32 accumulator equals
  ``lax.conv_general_dilated(..., preferred_element_type=int32)``, and the
  epilogue equals the JAX ``_qconv`` on the same accumulator. The int8 max
  pool and ``quantize_input`` are bitwise JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _qconv_cases import QCONV_SHAPES, port_operands, qconv_operands
from _torch_port_setup import make_cfgs, port_model, shared_weights
from far3d_tpu.ops import quant as jq
from far3d_tpu_torch.ops import quant as tq
from far3d_tpu_torch.ops.qconv import qconv, qconv_acc_reference

@pytest.mark.parametrize('name', sorted(QCONV_SHAPES))
def test_qconv_accumulator_matches_xla(name):
    sh = QCONV_SHAPES[name]
    x, w, a, b = qconv_operands(sh, 0)
    p = (sh['k'] - 1) // 2
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (sh['stride'],) * 2, ((p, p), (p, p)),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32)
    xt, wt, _, _ = port_operands(sh, 0, 'cpu')
    got = qconv_acc_reference(xt, wt, sh['stride'])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('float_out', [False, True])
@pytest.mark.parametrize('name', sorted(QCONV_SHAPES))
def test_qconv_matches_jax_qconv(name, float_out):
    """The whole op against the JAX ``_qconv`` (XLA's conv and epilogue):
    the f32 output within one f32 rounding of the product and the sum
    (XLA may contract them into one FMA), the int8 output equal but for
    ties that contraction moves (at most 0.1% of elements, by at most 1)."""
    sh = QCONV_SHAPES[name]
    x, w, a, b = qconv_operands(sh, 1)
    want = np.asarray(jq._qconv(
        dict(w=jnp.asarray(w), a=jnp.asarray(a), b=jnp.asarray(b)),
        jnp.asarray(x), stride=sh['stride'], float_out=float_out))
    got = qconv(*port_operands(sh, 1, 'cpu'), sh['stride'],
                float_out).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if float_out:
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-6)
    else:
        assert_int8_close(got, want, name)


def assert_int8_close(got, want, what, share=1e-3):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max(initial=0) <= 1, (what, diff.max())
    assert np.count_nonzero(diff) <= share * diff.size, \
        (what, np.count_nonzero(diff), diff.size)
    return np.count_nonzero(diff)


@pytest.mark.parametrize('hw', [(8, 12), (7, 9), (1, 2)])
def test_max_pool_matches_reduce_window(hw):
    x = np.random.RandomState(2).randint(-128, 128, (2, *hw, 5))
    x = x.astype(np.int8)
    want = jax.lax.reduce_window(jnp.asarray(x), jnp.int8(-128), jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), 'SAME')
    got = tq.max_pool_same(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_input_and_scale_match():
    mean, std = (103.53, 116.28, 123.675), (57.375, 57.12, 58.395)
    assert tq.input_scale_from_norm(mean, std) == \
        jq.input_scale_from_norm(mean, std)
    s0 = np.float32(jq.input_scale_from_norm(mean, std))
    x = (np.random.RandomState(3).randn(2, 6, 7, 3) * 2.5).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    want = jq.quantize_input(jnp.asarray(x), jnp.float32(s0))
    got = tq.quantize_input(torch.from_numpy(x.astype(np.float32))
                            .to(torch.bfloat16), torch.tensor(s0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the backbone: calibration, tree, forward
# ---------------------------------------------------------------------------

def normalized_images(cfg, seed, n=2):
    u8 = np.random.RandomState(seed).randint(
        0, 256, (n, *cfg.data.input_hw, 3)).astype(np.float32)
    x = (u8 - np.asarray(cfg.data.img_mean)) / np.asarray(cfg.data.img_std)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def nchw_bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)


@pytest.fixture(scope='module')
def backbones():
    jax_cfg, port_cfg = make_cfgs()
    variables, sd = shared_weights(jax_cfg, port_cfg, seed=0)
    jvars = {'params': variables['params']['backbone'],
             'stats': variables['stats']['backbone']}
    model = port_model(port_cfg, sd)
    calib = [normalized_images(jax_cfg, s) for s in (1, 2)]
    amax = jq.calibrate_vovnet(jax_cfg.backbone, jvars,
                               [jnp.asarray(c, jnp.bfloat16) for c in calib])
    mean, std = jax_cfg.data.img_mean, jax_cfg.data.img_std
    jtree = jq.build_quant_vovnet(jax_cfg.backbone, jvars, amax, mean, std)
    ttree = tq.build_quant_vovnet(model.img_backbone, amax, mean, std)
    return dict(jax_cfg=jax_cfg, port_cfg=port_cfg, jvars=jvars, model=model,
                calib=calib, amax=amax, jtree=jtree, ttree=ttree,
                variables=variables, sd=sd)


def _leaves(tree, prefix=''):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f'{prefix}{k}/')
        else:
            yield f'{prefix}{k}', v


def test_tree_bitwise_equal_from_same_amax(backbones):
    jl = dict(_leaves(backbones['jtree']))
    tl = dict(_leaves(backbones['ttree']))
    assert jl.keys() == tl.keys()
    assert len(jl) > 40
    for k in jl:
        want, got = np.asarray(jl[k]), tl[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    # the weights lie in memory as the kernel reads them
    for k, v in tl.items():
        if k.endswith('/w'):
            assert v.permute(3, 0, 1, 2).is_contiguous(), k


def test_calibration_matches_jax(backbones):
    got = tq.calibrate_vovnet(backbones['model'].img_backbone,
                              [nchw_bf16(c) for c in backbones['calib']])
    want = backbones['amax']
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)


def _walk(mod, cfg, q, x_q, to_np):
    """Each package's forward, step by step as its quant_vovnet_forward
    takes it: the int8 activation after every stem conv and OSA block, and
    the dequantized stage outputs."""
    acts, outs = {}, []
    x = mod._qconv(q['stem1'], x_q, stride=2)
    acts['stem1'] = to_np(x)
    x = mod._qconv(q['stem2'], x)
    acts['stem2'] = to_np(x)
    x = mod._qconv(q['stem3'], x, stride=2)
    acts['stem3'] = to_np(x)
    for si in range(4):
        stage = si + 2
        if stage != 2:
            x = (tq.max_pool_same(x) if mod is tq else jax.lax.reduce_window(
                x, jnp.int8(-128), jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                'SAME'))
        for bi in range(cfg.blocks_per_stage[si]):
            name = f'stage{stage}_block{bi}'
            x = mod._qosa(q[name], x, cfg.layers_per_block, identity=bi > 0)
            acts[name] = to_np(x)
    return acts


def test_forward_matches_jax(backbones):
    jcfg, tcfg = backbones['jax_cfg'], backbones['port_cfg']
    x = normalized_images(jcfg, 3)                        # held out
    jx = jq.quantize_input(jnp.asarray(x, jnp.bfloat16),
                           backbones['jtree']['s0'])
    tx = tq.quantize_input(torch.from_numpy(x).to(torch.bfloat16),
                           backbones['ttree']['s0'])
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    want = _walk(jq, jcfg.backbone, backbones['jtree'], jx, np.asarray)
    got = _walk(tq, tcfg.backbone, backbones['ttree'], tx,
                lambda t: t.numpy())
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == np.int8 and got[k].shape == want[k].shape, k
        assert_int8_close(got[k], want[k], k)

    jstages = jq.quant_vovnet_forward(jcfg.backbone, backbones['jtree'], jx)
    tstages = tq.quant_vovnet_forward(tcfg.backbone, backbones['ttree'], tx)
    assert len(tstages) == len(jstages) == 4
    for i, (t, j) in enumerate(zip(tstages, jstages)):
        assert t.dtype == torch.bfloat16
        t = t.permute(0, 2, 3, 1).float().numpy()
        j = np.asarray(j, np.float32)
        scale = float(backbones['ttree'][f'stage{i + 2}_scale'])
        assert t.shape == j.shape
        assert np.abs(t - j).max() <= 2 * scale, (i, np.abs(t - j).max(),
                                                  scale)


def test_quant_backbone_close_to_bf16(backbones):
    """The int8 stage outputs against the port's own bf16 backbone on a
    held-out input: within the relative L2 bound of tests/test_quant.py."""
    x = normalized_images(backbones['jax_cfg'], 3)
    model = backbones['model']
    q = backbones['ttree']
    with torch.no_grad():
        ref = model.img_backbone(nchw_bf16(x))
    got = tq.quant_vovnet_forward(
        backbones['port_cfg'].backbone, q,
        tq.quantize_input(torch.from_numpy(x).to(torch.bfloat16), q['s0']))
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = a.float(), b.float()
        rel = ((a - b).norm() / b.norm().clamp_min(1e-6)).item()
        assert rel < 0.08, (i, rel)
