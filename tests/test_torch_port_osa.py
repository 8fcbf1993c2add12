"""The port's fused OSA block (far3d_tpu_torch/ops/osa.py) against the JAX
tool tools/dev_micro_osa_pallas.py: the layout helpers, the plain version
`osa_reference` against the Pallas kernel run in interpret mode and against
the tool's XLA chain, and `pack_osa_weights` + `osa_block` against the flax
OSAModule and the port's OSAModule on shared weights. On the CPU the port's
`fused_osa` takes `osa_reference`; the CUDA kernel is held to it on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerances. Both sides sum bf16 products in f32, in another order, and round
once to bf16 per stage, so an output may sit one bf16 step (2^-8 relative)
apart per stage, six stages deep: y is held to 6 * 2^-8 of the tensor's
largest entry, tsum (f32 sums of the unrounded values) to 1e-3 of its
largest. Against the OSAModules, which round the conv to bf16 before a bf16
BN multiply and add where the fused block applies the BN in f32, the bound
is 8 * 2^-8 of the largest entry.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from far3d_tpu.models.vovnet import OSAModule as JaxOSAModule
from far3d_tpu_torch.models.vovnet import OSAModule as TorchOSAModule
from far3d_tpu_torch.ops import osa
from far3d_tpu_torch.utils.convert import _to_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16_STEP = 2.0 ** -8


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        'dev_micro_osa_pallas', ROOT / 'tools' / 'dev_micro_osa_pallas.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load_tool()

SHAPES = {
    'n2_6x10': dict(n=2, h=6, w=10, wp=16, cin=32, cm=16, cout=32),
    'cout512_two_chunks': dict(n=1, h=4, w=7, wp=8, cin=32, cm=16, cout=512),
    'n3_5x11': dict(n=3, h=5, w=11, wp=16, cin=48, cm=32, cout=48),
}


def _bf16(a):
    """numpy f32 -> the nearest bf16 values, still as f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _case(sh, seed):
    """Asymmetric random operands (numpy, seeded), already bf16-exact where
    the kernel takes bf16, so both frameworks see the same values."""
    rng = np.random.default_rng(seed)
    n, h, w, cin, cm, cout = (sh[k] for k in ('n', 'h', 'w', 'cin', 'cm',
                                              'cout'))
    x = _bf16((rng.standard_normal((n, h, w, cin)) * 0.5).astype(np.float32))
    weights = {
        'w1': _bf16((rng.standard_normal((9 * cin, cm))
                     / np.sqrt(9 * cin)).astype(np.float32)),
        'w2345': _bf16((rng.standard_normal((4 * 9 * cm, cm))
                        / np.sqrt(9 * cm)).astype(np.float32)),
        'wcat': _bf16((rng.standard_normal((cin + 5 * cm, cout))
                       / np.sqrt(cin + 5 * cm)).astype(np.float32)),
        's5': rng.uniform(0.8, 1.2, (5, cm)).astype(np.float32),
        'b5': (rng.standard_normal((5, cm)) * 0.1).astype(np.float32),
        'sc': rng.uniform(0.8, 1.2, (1, cout)).astype(np.float32),
        'bc': (rng.standard_normal((1, cout)) * 0.1).astype(np.float32),
    }
    return x, weights


BF16_KEYS = ('w1', 'w2345', 'wcat')


def _torch_operands(x, weights, sh):
    xp = osa.pad_plane(torch.from_numpy(x).to(torch.bfloat16), sh['wp'])
    wt = {k: torch.from_numpy(v).to(torch.bfloat16 if k in BF16_KEYS
                                    else torch.float32)
          for k, v in weights.items()}
    return xp, osa.interior_mask(sh['h'], sh['w'], sh['wp']), wt


def _jax_operands(x, weights, sh):
    xp = tool.pad_plane(jnp.asarray(x, jnp.bfloat16), sh['wp'])
    wj = {k: jnp.asarray(v, jnp.bfloat16 if k in BF16_KEYS else jnp.float32)
          for k, v in weights.items()}
    r = sh['h'] * sh['wp']
    col = (np.arange(r) % sh['wp'] < sh['w']).astype(np.float32)[:, None]
    return xp, jnp.asarray(col, jnp.bfloat16), wj


def _pallas_interpret(xp, mask, wj, sh):
    """The tool's kernel body in its own pallas_call, with the block specs of
    the tool's build_call, in interpret mode (build_call has no such switch)."""
    n, h, wp, cin, cm, cout = (sh[k] for k in ('n', 'h', 'wp', 'cin', 'cm',
                                               'cout'))
    r = h * wp
    rp = r + 2 * tool.HALO
    call = pl.pallas_call(
        tool.make_osa_kernel(h, wp, cin, cm, cout, r, rp),
        grid=(n,),
        in_specs=[
            pl.BlockSpec((1, rp, cin), lambda i: (i, 0, 0)),
            pl.BlockSpec((r, 1), lambda i: (0, 0)),
            pl.BlockSpec((9 * cin, cm), lambda i: (0, 0)),
            pl.BlockSpec((4 * 9 * cm, cm), lambda i: (0, 0)),
            pl.BlockSpec((cin + 5 * cm, cout), lambda i: (0, 0)),
            pl.BlockSpec((5, cm), lambda i: (0, 0)),
            pl.BlockSpec((5, cm), lambda i: (0, 0)),
            pl.BlockSpec((1, cout), lambda i: (0, 0)),
            pl.BlockSpec((1, cout), lambda i: (0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((1, rp, cout), lambda i: (i, 0, 0)),
            pl.BlockSpec((1, 1, cout), lambda i: (i, 0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n, rp, cout), jnp.bfloat16),
            jax.ShapeDtypeStruct((n, 1, cout), jnp.float32),
        ],
        scratch_shapes=[pltpu.VMEM((rp, cm), jnp.bfloat16)] * 5
        + [pltpu.VMEM((r, cm), jnp.float32)],
        interpret=True)
    return call(xp, mask, wj['w1'], wj['w2345'], wj['wcat'], wj['s5'],
                wj['b5'], wj['sc'], wj['bc'])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _assert_y_close(got, want, steps, msg=''):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, err_msg=msg,
                               atol=steps * BF16_STEP * scale)


@pytest.mark.parametrize('stage', [3, 4])
def test_shapes_for_stage(stage):
    assert osa.shapes_for_stage(stage) == tool.shapes_for_stage(stage)
    assert osa.HALO == tool.HALO and osa.OFFS == tool.OFFS


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_layout_helpers(name):
    sh = SHAPES[name]
    x, weights = _case(sh, seed=1)
    xp_t, mask_t, _ = _torch_operands(x, weights, sh)
    xp_j, mask_j, _ = _jax_operands(x, weights, sh)
    np.testing.assert_array_equal(_f32(xp_t), _f32(xp_j))
    np.testing.assert_array_equal(_f32(mask_t), _f32(mask_j))
    h, w, wp = sh['h'], sh['w'], sh['wp']
    back_t = osa.unpad_plane(xp_t, h, w, wp)
    np.testing.assert_array_equal(_f32(back_t),
                                  _f32(tool.unpad_plane(xp_j, h, w, wp)))
    np.testing.assert_array_equal(_f32(back_t), x)


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_reference_matches_pallas_interpret(name):
    sh = SHAPES[name]
    x, weights = _case(sh, seed=2)
    y_t, tsum_t = osa.fused_osa(*_torch_operands(x, weights, sh), sh)
    y_j, tsum_j = _pallas_interpret(*_jax_operands(x, weights, sh), sh)
    assert y_t.dtype == torch.bfloat16 and tsum_t.dtype == torch.float32
    assert tuple(y_t.shape) == y_j.shape and tuple(tsum_t.shape) == tsum_j.shape
    _assert_y_close(_f32(y_t), _f32(y_j), steps=6)
    want = _f32(tsum_j)
    np.testing.assert_allclose(_f32(tsum_t), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())
    r = sh['h'] * sh['wp']
    halo = torch.cat([y_t[:, :osa.HALO], y_t[:, osa.HALO + r:]], dim=1)
    assert not halo.any(), 'halo rows of y_pad must be zero'
    pad_cols = y_t[:, osa.HALO:osa.HALO + r].reshape(
        sh['n'], sh['h'], sh['wp'], -1)[:, :, sh['w']:]
    assert not pad_cols.any(), 'pad columns of y_pad must be zero'


# the tool's stage-3 layout has a halo of exactly wp rows, so its corner taps
# start one row outside the plane (a corner of the zero padding); held to
# the layout-free XLA chain only
HALO_EQUALS_WP = dict(n=2, h=3, w=100, wp=128, cin=32, cm=16, cout=32)


@pytest.mark.parametrize('name', sorted(SHAPES) + ['halo_equals_wp'])
def test_reference_matches_xla_osa(name):
    sh = SHAPES.get(name, HALO_EQUALS_WP)
    x, weights = _case(sh, seed=3)
    xp, mask, wt = _torch_operands(x, weights, sh)
    y_t, tsum_t = osa.osa_reference(xp, mask, wt, sh)
    _, _, wj = _jax_operands(x, weights, sh)
    want = _f32(tool.xla_osa(jnp.asarray(x, jnp.bfloat16), wj, sh))
    got = _f32(osa.unpad_plane(y_t, sh['h'], sh['w'], sh['wp']))
    _assert_y_close(got, want, steps=6)
    # the XLA chain returns the rounded y only: its sum over the plane is
    # tsum up to the bf16 rounding of each of the h*w terms
    tsum_want = want.reshape(sh['n'], -1, sh['cout']).sum(axis=1)
    np.testing.assert_allclose(_f32(tsum_t)[:, 0], tsum_want, rtol=0,
                               atol=BF16_STEP * np.abs(tsum_want).max())


def test_negative_bias_zeroes_a_stage():
    """A large negative bias on the third conv makes ReLU zero all of c3; c4
    and c5 then come from their biases alone."""
    sh = SHAPES['n2_6x10']
    x, weights = _case(sh, seed=4)
    weights['b5'][2] = -100.0
    y_t, tsum_t = osa.fused_osa(*_torch_operands(x, weights, sh), sh)
    y_j, tsum_j = _pallas_interpret(*_jax_operands(x, weights, sh), sh)
    _assert_y_close(_f32(y_t), _f32(y_j), steps=6)
    np.testing.assert_allclose(_f32(tsum_t), _f32(tsum_j), rtol=0,
                               atol=1e-3 * np.abs(_f32(tsum_j)).max())


# ---- pack_osa_weights and osa_block against the OSAModules ---------------

MOD = dict(n=2, h=6, w=9, wp=16, cin=32, cm=16, cout=32)


def _flax_variables(sh, seed):
    """Random variables of one flax OSAModule with five convs, BN statistics
    away from (0, 1), as numpy."""
    rng = np.random.default_rng(seed)
    cin, cm, cout = sh['cin'], sh['cm'], sh['cout']
    params, stats = {}, {}

    def conv_bn(name, c_in, c_out, k):
        params[name] = {
            'conv': {'kernel': (rng.standard_normal((k, k, c_in, c_out))
                                / np.sqrt(k * k * c_in)).astype(np.float32)},
            'bn': {'scale': rng.uniform(0.75, 1.25, c_out).astype(np.float32),
                   'bias': (rng.standard_normal(c_out) * 0.1).astype(np.float32)}}
        stats[name] = {'bn': {
            'mean': (rng.standard_normal(c_out) * 0.1).astype(np.float32),
            'var': rng.uniform(0.5, 1.5, c_out).astype(np.float32)}}

    for i in range(5):
        conv_bn(f'layer{i}', cin if i == 0 else cm, cm, 3)
    conv_bn('concat', cin + 5 * cm, cout, 1)
    params['ese'] = {'fc': {
        'kernel': (rng.standard_normal((1, 1, cout, cout))
                   / np.sqrt(cout)).astype(np.float32),
        'bias': (rng.standard_normal(cout) * 0.1).astype(np.float32)}}
    return {'params': params, 'stats': stats}


def _port_module(variables, sh, identity=True):
    """The flax variables carried into the port's OSAModule, with the layout
    transforms of utils/convert.py (flax HWIO conv -> torch OIHW)."""
    mod = TorchOSAModule(sh['cin'], sh['cm'], sh['cout'], 5, name='OSA',
                         identity=identity).eval()
    params, stats = variables['params'], variables['stats']

    def load(block, name):
        conv, bn = block[0], block[1]
        tensors = {
            conv.weight: _to_reference(params[name]['conv']['kernel'], 'conv'),
            bn.weight: params[name]['bn']['scale'],
            bn.bias: params[name]['bn']['bias'],
            bn.running_mean: stats[name]['bn']['mean'],
            bn.running_var: stats[name]['bn']['var']}
        for dst, src in tensors.items():
            assert tuple(dst.shape) == src.shape
            dst.data.copy_(torch.from_numpy(np.ascontiguousarray(src)))

    for i, layer in enumerate(mod.layers):
        load(layer, f'layer{i}')
    load(mod.concat, 'concat')
    fc = params['ese']['fc']
    mod.ese.fc.weight.data.copy_(torch.from_numpy(np.ascontiguousarray(
        _to_reference(fc['kernel'], 'conv'))))
    mod.ese.fc.bias.data.copy_(torch.from_numpy(fc['bias']))
    return mod


@pytest.fixture(scope='module')
def shared_block():
    sh = MOD
    variables = _flax_variables(sh, seed=5)
    rng = np.random.default_rng(6)
    x = _bf16((rng.standard_normal((sh['n'], sh['h'], sh['w'], sh['cin']))
               * 0.5).astype(np.float32))
    mod = _port_module(variables, sh)
    packed = osa.pack_osa_weights(mod)
    mask = osa.interior_mask(sh['h'], sh['w'], sh['wp'])
    xp = osa.pad_plane(torch.from_numpy(x).to(torch.bfloat16), sh['wp'])
    with torch.no_grad():
        out_pad = osa.osa_block(mod, xp, mask, packed, sh)
    got = _f32(osa.unpad_plane(out_pad, sh['h'], sh['w'], sh['wp']))
    return dict(sh=sh, variables=variables, x=x, mod=mod, packed=packed,
                mask=mask, xp=xp, out_pad=out_pad, got=got)


def test_pack_osa_weights_layout(shared_block):
    """w1 and w2345 are the flax HWIO kernels reshaped tap-major, wcat the
    1x1 kernel, the scales and biases the f32 BN fold."""
    b, sh = shared_block, shared_block['sh']
    params, stats = b['variables']['params'], b['variables']['stats']
    cin, cm = sh['cin'], sh['cm']
    p = b['packed']
    np.testing.assert_array_equal(
        _f32(p['w1']), _bf16(params['layer0']['conv']['kernel'].reshape(
            9 * cin, cm)))
    for i in range(1, 5):
        np.testing.assert_array_equal(
            _f32(p['w2345'][(i - 1) * 9 * cm:i * 9 * cm]),
            _bf16(params[f'layer{i}']['conv']['kernel'].reshape(9 * cm, cm)))
    np.testing.assert_array_equal(
        _f32(p['wcat']), _bf16(params['concat']['conv']['kernel'][0, 0]))
    for i in range(5):
        bn, st = params[f'layer{i}']['bn'], stats[f'layer{i}']['bn']
        inv = bn['scale'] / np.sqrt(st['var'] + 1e-5)
        np.testing.assert_allclose(_f32(p['s5'][i]), inv, rtol=1e-6)
        np.testing.assert_allclose(_f32(p['b5'][i]),
                                   bn['bias'] - st['mean'] * inv,
                                   rtol=1e-5, atol=1e-6)
    assert p['sc'].shape == (1, sh['cout']) and p['bc'].shape == (1, sh['cout'])
    assert all(p[k].dtype == torch.bfloat16 for k in BF16_KEYS)
    assert all(p[k].dtype == torch.float32 for k in ('s5', 'b5', 'sc', 'bc'))


def test_osa_block_matches_flax_module(shared_block):
    b, sh = shared_block, shared_block['sh']
    variables = jax.tree_util.tree_map(jnp.asarray, b['variables'])
    want = JaxOSAModule(stage_ch=sh['cm'], concat_ch=sh['cout'],
                        layers_per_block=5, identity=True).apply(
        variables, jnp.asarray(b['x'], jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    _assert_y_close(b['got'], _f32(want), steps=8)


def test_osa_block_matches_port_module(shared_block):
    b = shared_block
    x = torch.from_numpy(b['x']).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = b['mod'](x).permute(0, 2, 3, 1)
    _assert_y_close(b['got'], _f32(want), steps=8)


def test_port_module_matches_flax_module(shared_block):
    """The carrier itself: the port's OSAModule on the converted weights is
    the flax module (two bf16 chains of the same order of operations)."""
    b, sh = shared_block, shared_block['sh']
    variables = jax.tree_util.tree_map(jnp.asarray, b['variables'])
    want = JaxOSAModule(stage_ch=sh['cm'], concat_ch=sh['cout'],
                        layers_per_block=5, identity=True).apply(
        variables, jnp.asarray(b['x'], jnp.bfloat16))
    x = torch.from_numpy(b['x']).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = b['mod'](x).permute(0, 2, 3, 1)
    _assert_y_close(_f32(got), _f32(want), steps=8)


def test_chain_of_three_blocks_keeps_zeros(shared_block):
    """cin == cout, so a block's output is the next block's input; halo rows
    and pad columns must stay zero through the gate and the identity add."""
    b, sh = shared_block, shared_block['sh']
    r = sh['h'] * sh['wp']
    mods = [b['mod']] + [_port_module(_flax_variables(sh, seed=7 + i), sh)
                         for i in range(2)]
    xp = b['xp']
    x = torch.from_numpy(b['x']).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        for mod in mods:
            xp = osa.osa_block(mod, xp, b['mask'], osa.pack_osa_weights(mod),
                               sh)
            assert xp.dtype == torch.bfloat16 and torch.isfinite(xp).all()
            assert not xp[:, :osa.HALO].any()
            assert not xp[:, osa.HALO + r:].any()
            plane = xp[:, osa.HALO:osa.HALO + r].reshape(
                sh['n'], sh['h'], sh['wp'], -1)
            assert not plane[:, :, sh['w']:].any()
            assert plane[:, :, :sh['w']].any()
            x = mod(x)
    got = _f32(osa.unpad_plane(xp, sh['h'], sh['w'], sh['wp']))
    _assert_y_close(got, _f32(x.permute(0, 2, 3, 1)), steps=3 * 8)


def test_pack_refuses_other_depths():
    mod = TorchOSAModule(32, 16, 32, 2, name='OSA', identity=True)
    with pytest.raises(ValueError, match='3x3 convs'):
        osa.pack_osa_weights(mod)


def test_fused_osa_without_identity(shared_block):
    """A stage's first block has no identity add (and cin != cout there)."""
    sh = dict(MOD, cin=48)
    mod = _port_module(_flax_variables(sh, seed=11), sh, identity=False)
    rng = np.random.default_rng(12)
    x = _bf16((rng.standard_normal((sh['n'], sh['h'], sh['w'], sh['cin']))
               * 0.5).astype(np.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        out = osa.osa_block(mod, osa.pad_plane(xt, sh['wp']),
                            shared_block['mask'], osa.pack_osa_weights(mod), sh)
        want = mod(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = _f32(osa.unpad_plane(out, sh['h'], sh['w'], sh['wp']))
    _assert_y_close(got, _f32(want), steps=8)
