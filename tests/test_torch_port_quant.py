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
  ``lax.conv_general_dilated(..., preferred_element_type=int32)``, also on
  channel slices of wider buffers, and the epilogue equals the JAX
  ``_qconv`` on the same accumulator; written into a channel slice, it
  leaves the rest of the buffer alone. The int8 max pool and
  ``quantize_input`` are bitwise JAX's.
* The OSA block tail (``ese_gate`` + ``ese_requant_reference``) is bitwise
  the JAX ``_qosa``'s tail on the same concat-conv output; the block with
  its concat read and written in place is bitwise the ``torch.cat`` block
  it replaced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _qconv_cases import (QCONV_SHAPES, QCONV_SLICES, SENTINEL, port_operands,
                          qconv_operands, slice_operands)
from _torch_port_setup import make_cfgs, port_model, shared_weights
from far3d_tpu.ops import quant as jq
from far3d_tpu_torch.ops import quant as tq
from far3d_tpu_torch.ops.qconv import (qconv, qconv_acc_reference,
                                       qconv_reference)

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


@pytest.mark.parametrize('float_out', [False, True])
@pytest.mark.parametrize('name', sorted(QCONV_SLICES))
def test_qconv_slices_match_xla(name, float_out):
    """A channel slice of a wider buffer in, a channel slice out, as the
    int8 OSA block reads and writes its concat buffer: the accumulator is
    XLA's on the same slice, the slice written is the contiguous result,
    bitwise, and nothing else of the output buffer changes."""
    sh = QCONV_SLICES[name]
    x, w, a, b, out_buf, out = slice_operands(sh, 0, 'cpu', float_out)
    assert not x.is_contiguous() and not out.is_contiguous()
    p = (sh['k'] - 1) // 2
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(w.permute(1, 2, 3, 0).numpy()),
        (sh['stride'],) * 2, ((p, p), (p, p)),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(
        qconv_acc_reference(x, w, sh['stride']).numpy(), np.asarray(want))
    got = qconv(x, w, a, b, sh['stride'], float_out, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, qconv(x.contiguous(), w, a, b, sh['stride'],
                                  float_out))
    rest = torch.ones(sh['out_pitch'], dtype=torch.bool)
    rest[sh['out_off']:sh['out_off'] + sh['co']] = False
    assert (out_buf[..., rest] == SENTINEL).all()


@pytest.mark.parametrize('name', ['concat_1x1', 'tma_wide_1x1'])
def test_qconv_channel_sums_are_the_outputs_sums(name):
    """The plain version's channel sums: ``Tensor.sum`` over each image of
    the f32 output it returns, the eSE mean times h*w."""
    sh = QCONV_SHAPES[name]
    ops = port_operands(sh, 4, 'cpu')
    y, sums = qconv_reference(*ops, sh['stride'], True, channel_sums=True)
    assert torch.equal(y, qconv(*ops, sh['stride'], True))
    assert torch.equal(sums, y.sum(dim=(1, 2)))
    assert torch.equal(sums / (y.shape[1] * y.shape[2]), y.mean(dim=(1, 2)))
    with pytest.raises(ValueError, match='float output'):
        qconv_reference(*ops, sh['stride'], False, channel_sums=True)


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


@pytest.mark.parametrize('identity', [False, True])
def test_plain_tail_matches_jax_tail(identity, monkeypatch):
    """The block tail the port runs on the CPU (``ese_gate`` from the
    concat conv's channel sums, then ``ese_requant_reference``) against the
    JAX ``_qosa``'s own tail, fed the same concat-conv output through a
    stand-in ``_qconv``: bitwise. The operands are dyadic with h*w = 32, so
    that the eSE mean and the gate product are exact in any order of
    summation and the comparison is one of the elementwise rounding."""
    rng = np.random.RandomState(5)
    n, h, w, c, layers = 2, 4, 8, 48, 2
    y = (np.maximum(rng.randint(-50, 200, (n, h, w, c)), 0) / 4.0).astype(
        np.float32)
    x = rng.randint(0, 128, (n, h, w, c)).astype(np.int8)
    blk = dict(ese_w=(rng.randint(-8, 9, (c, c)) / 16.0).astype(np.float32),
               ese_b=(rng.randint(-48, 49, c) / 16.0).astype(np.float32),
               s_id=np.float32(0.021), r_out=np.float32(37.3))

    def fake_qconv(qc, x_q, stride=1, float_out=False):
        return (jnp.asarray(y) if float_out
                else jnp.zeros((*x_q.shape[:3], 8), jnp.int8))

    monkeypatch.setattr(jq, '_qconv', fake_qconv)
    jblk = {k: jnp.asarray(v) for k, v in blk.items()}
    jblk.update({f'layer{li}': {} for li in range(layers)}, concat={})
    want = np.asarray(jq._qosa(jblk, jnp.asarray(x), layers, identity))
    tblk = {k: torch.from_numpy(np.asarray(v)) for k, v in blk.items()}
    yt = torch.from_numpy(y)
    gate = tq.ese_gate(tblk, yt.sum(dim=(1, 2)), h * w)
    got = tq.ese_requant(yt, gate, tblk['r_out'],
                         torch.from_numpy(x) if identity else None,
                         tblk['s_id'] if identity else None)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < np.count_nonzero(want == 127) < want.size


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


def _qosa_cat(blk, x_q, layers, identity):
    """The int8 OSA block as the port ran it before the concat was read in
    place: each layer conv into a new tensor, ``torch.cat``, the concat conv,
    then the eSE gate, identity add and requantization as PyTorch passes
    (the yardstick of the in-place block)."""
    outs, h = [x_q], x_q
    for li in range(layers):
        h = tq._qconv(blk[f'layer{li}'], h)
        outs.append(h)
    y = tq._qconv(blk['concat'], torch.cat(outs, dim=-1), float_out=True)
    s = y.mean(dim=(1, 2))
    g = s @ blk['ese_w'] + blk['ese_b']
    y.mul_(((g + 3.0).clamp(0.0, 6.0) / 6.0)[:, None, None, :])
    if identity:
        y.add_(x_q * blk['s_id'])
    return y.mul_(blk['r_out']).round_().clamp_(0, 127).to(torch.int8)


def _forward_cat(cfg, q, x_q):
    """``quant_vovnet_forward`` as the port ran it before (each block through
    ``_qosa_cat``): the block outputs and the stage outputs."""
    x = tq._qconv(q['stem1'], x_q, stride=2)
    x = tq._qconv(q['stem2'], x)
    x = tq._qconv(q['stem3'], x, stride=2)
    blocks, outputs = [], []
    for si in range(4):
        stage = si + 2
        if stage != 2:
            x = tq.max_pool_same(x)
        for bi in range(cfg.blocks_per_stage[si]):
            x = _qosa_cat(q[f'stage{stage}_block{bi}'], x,
                          cfg.layers_per_block, identity=(bi > 0))
            blocks.append(x)
        if stage in cfg.out_stages:
            outputs.append((x * q[f'stage{stage}_scale'])
                           .to(torch.bfloat16).permute(0, 3, 1, 2))
    return blocks, outputs


def test_inplace_concat_forward_matches_cat_version(backbones, monkeypatch):
    """``quant_vovnet_forward`` with each block's concat one buffer read and
    written in place (stem3 and each block writing into the next block's
    slice 0) against the same forward through ``_qosa_cat``: every block's
    int8 output and every stage output bitwise equal."""
    cfg, q = backbones['port_cfg'].backbone, backbones['ttree']
    x = normalized_images(backbones['jax_cfg'], 6)
    x_q = tq.quantize_input(torch.from_numpy(x).to(torch.bfloat16), q['s0'])
    got_blocks, real = [], tq._qosa

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        got_blocks.append(out.clone())
        return out

    monkeypatch.setattr(tq, '_qosa', recording)
    got = tq.quant_vovnet_forward(cfg, q, x_q)
    want_blocks, want = _forward_cat(cfg, q, x_q)
    assert len(got_blocks) == len(want_blocks) == sum(cfg.blocks_per_stage)
    for i, (g, w) in enumerate(zip(got_blocks, want_blocks)):
        assert torch.equal(g, w), i
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
