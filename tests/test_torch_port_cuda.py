"""The hand-written CUDA kernels (the MSDA forward, its two backward
kernels through autograd, and the fused OSA block) against their plain
PyTorch versions, on the card, and the dataset-to-metric path there (the
uint8 input branch against the CPU, two steps of the training runner from a
PNG dataset on disk, a checkpoint round trip of a card state). These tests import neither jax nor the JAX package, and skip where
there is no card. On a machine with a card and without jax:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from _msda_cases import CASES
from _osa_cases import OSA_SHAPES, assert_osa_close, osa_operands
from far3d_tpu_torch.ops import _build, msda_cuda, osa, osa_cuda
from far3d_tpu_torch.ops.msda import (msda, msda_backward_reference,
                                      msda_reference)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (the CUDA kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_cuda_kernel_matches_reference(case, cuda_device):
    value, shapes, loc, weights = CASES[case]()
    v, l, w = [torch.from_numpy(a).to(cuda_device)
               for a in (value, loc, weights)]
    before = _build.launch_counts.get('msda_fwd', 0)
    got = msda(v, shapes, l, w)
    torch.cuda.synchronize()
    assert _build.launch_counts['msda_fwd'] == before + 1
    want = msda_reference(v, shapes, l, w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_bf16_value(cuda_device):
    """bf16 value rows, f32 loc and weights: both sides accumulate in f32 and
    round once to bf16, so they may differ by one bf16 step (2^-8)."""
    value, shapes, loc, weights = CASES['mixed']()
    v = torch.from_numpy(value).to(cuda_device, torch.bfloat16)
    l, w = [torch.from_numpy(a).to(cuda_device) for a in (loc, weights)]
    got = msda(v, shapes, l, w)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, msda_reference(v, shapes, l, w),
                               rtol=1e-2, atol=1e-3)


def _backward_case(case, dev, dtype=torch.float32):
    value, shapes, loc, weights = CASES[case]()
    g_out = np.random.RandomState(7).randn(
        value.shape[0], loc.shape[1], value.shape[2]).astype(np.float32)
    v, l, w, g = [torch.from_numpy(a).to(dev) for a in (value, loc, weights,
                                                         g_out)]
    return v.to(dtype), shapes, l, w, g.to(dtype)


def _kernel_grads(v, shapes, l, w, g):
    v, l, w = [t.clone().requires_grad_() for t in (v, l, w)]
    msda(v, shapes, l, w).backward(g)
    torch.cuda.synchronize()
    return v.grad, l.grad, w.grad


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_cuda_backward_matches_reference(case, cuda_device):
    """msda_dval and msda_dattn through autograd against autograd through the
    plain version, f32: the kernels sum in another order, 1e-5. Two cases
    sum terms that cancel into large location gradients, so there atol is a
    share of each tensor's largest entry: production_like (256 channels x 4
    corners x 4 levels; d_loc up to 854, the plain f32 backward alone 7.1e-4
    = 8e-7 of that from an f64 one) 4e-6, sparse_pairs (the same widths;
    d_loc up to 1,053, the kernels 1.2e-4 = 1.2e-7 of that from the plain
    backward on an H100) 5e-7, rows_past_int16 (maps 240 wide; d_loc up to
    1,320, the plain f32 backward 1.0e-2 = 8e-6 of that) 5e-5."""
    v, shapes, l, w, g = _backward_case(case, cuda_device)
    got = _kernel_grads(v, shapes, l, w, g)
    want = msda_backward_reference(v, shapes, l, w, g)
    share = {'production_like': 4e-6, 'sparse_pairs': 5e-7,
             'rows_past_int16': 5e-5}.get(case)
    for name, a, b in zip(('d_value', 'd_loc', 'd_weights'), got, want):
        atol = share * b.abs().max().item() if share else 1e-5
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol, msg=name)
    if case == 'outside':
        assert not got[0].any() and not got[1].any()


@pytest.mark.cuda
def test_cuda_backward_bf16_value(cuda_device):
    """bf16 value and gradient rows, f32 loc and weights: both sides sum in
    f32 from the same bf16 inputs; d_value is rounded once to bf16, so it may
    differ by one bf16 step (2^-8 relative)."""
    v, shapes, l, w, g = _backward_case('mixed', cuda_device, torch.bfloat16)
    got = _kernel_grads(v, shapes, l, w, g)
    want = msda_backward_reference(v, shapes, l, w, g)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    torch.testing.assert_close(got[0], want[0], rtol=1e-2, atol=1e-3)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', ['crowded', 'production_like',
                                  'rows_past_int16'])
def test_cuda_dval_is_bitwise_repeatable(case, dtype, cuda_device):
    """No float atomics: every row's hits are summed in the sorted order, a
    long row's chunk partials in chunk order (int16 keys, and int32 keys for
    rows_past_int16). A second call also finds other scratch memory. Held to
    the plain backward as well (1e-5 in f32, one bf16 step in bf16)."""
    v, shapes, l, w, g = _backward_case(case, cuda_device, dtype)
    first = msda_cuda.msda_dval(v, shapes, l, w, g)
    junk = torch.full((64, 2**20), 7.0, device=cuda_device)   # dirty the pool
    del junk
    second = msda_cuda.msda_dval(v, shapes, l, w, g)
    torch.cuda.synchronize()
    assert first.dtype == dtype and torch.equal(first, second)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-3))
    torch.testing.assert_close(
        first, msda_backward_reference(v, shapes, l, w, g)[0], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', ['crowded', 'production_like',
                                  'rows_past_int16', 'sparse_pairs'])
def test_cuda_dattn_is_bitwise_repeatable(case, dtype, cuda_device):
    """No float atomics: each point with an in-bounds corner is summed by one
    warp in a fixed order, whichever warp takes it. A second call also finds
    other memory in the pool (every output element must be written). Held
    to the plain backward as well: both sum in f32 (from the same bf16
    inputs in bf16), rtol and atol 1e-5 in f32 as in
    test_cuda_backward_matches_reference and 1e-4 in bf16 as in
    test_cuda_backward_bf16_value; where the location gradients cancel
    into large sums, atol at least a share of the largest entry: 4e-6 at
    the model's widths (production_like, sparse_pairs; the bf16 inputs as
    well), 5e-5 at rows_past_int16."""
    v, shapes, l, w, g = _backward_case(case, cuda_device, dtype)
    d_loc, d_weights = msda_cuda.msda_dattn(v, shapes, l, w, g)
    junk = torch.full((64, 2**20), 7.0, device=cuda_device)   # dirty the pool
    del junk
    d_loc2, d_weights2 = msda_cuda.msda_dattn(v, shapes, l, w, g)
    torch.cuda.synchronize()
    assert torch.equal(d_loc, d_loc2) and torch.equal(d_weights, d_weights2)
    want = msda_backward_reference(v, shapes, l, w, g)[1:]
    share = {'production_like': 4e-6, 'sparse_pairs': 4e-6,
             'rows_past_int16': 5e-5}.get(case, 0.)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    for name, a, b in zip(('d_loc', 'd_weights'), (d_loc, d_weights), want):
        atol = max(tol, share * b.abs().max().item())
        torch.testing.assert_close(a, b, rtol=tol, atol=atol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cuda_fwd_is_bitwise_repeatable(dtype, cuda_device):
    value, shapes, loc, weights = CASES['production_like']()
    v = torch.from_numpy(value).to(cuda_device, dtype)
    l, w = [torch.from_numpy(a).to(cuda_device) for a in (loc, weights)]
    first = msda_cuda.msda_fwd(v, shapes, l, w)
    second = msda_cuda.msda_fwd(v, shapes, l, w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_backward_takes_expanded_grad_out(cuda_device):
    """The decoder sums the cameras (decoder.py:106); at batch 1 the
    gradient of that sum reaches the kernel as a stride-0 view."""
    v, shapes, l, w, g = _backward_case('in_bounds', cuda_device)
    n, q, c = g.shape
    ct = g[:1]
    v1, l1, w1 = [t.clone().requires_grad_() for t in (v, l, w)]
    msda(v1, shapes, l1, w1).reshape(1, n, q, c).sum(1).backward(ct)
    want = msda_backward_reference(v, shapes, l, w, ct.expand(n, q, c))
    for a, b in zip((v1.grad, l1.grad, w1.grad), want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_backward_refuses_other_layouts(cuda_device):
    v, shapes, l, w, g = _backward_case('in_bounds', cuda_device)
    g_t = g.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match='contiguous'):
        msda_cuda.msda_dval(v, shapes, l, w, g_t)
    with pytest.raises(ValueError, match='contiguous'):
        msda_cuda.msda_dattn(v, shapes, l, w, g_t)


@pytest.mark.cuda
def test_cuda_backward_launches_each_kernel_once(cuda_device):
    v, shapes, l, w, g = _backward_case('mixed', cuda_device)
    v, l, w = [t.requires_grad_() for t in (v, l, w)]
    out = msda(v, shapes, l, w)
    before = dict(_build.launch_counts)
    out.backward(g)
    torch.cuda.synchronize()
    for name in ('msda_dval', 'msda_dattn'):
        assert _build.launch_counts[name] == before[name] + 1, name
    assert _build.launch_counts['msda_fwd'] == before['msda_fwd']


# ---- the fused OSA block ---------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(OSA_SHAPES))
def test_cuda_osa_matches_reference(name, cuda_device):
    sh = OSA_SHAPES[name]
    x_pad, mask, weights = osa_operands(sh, 0, cuda_device)
    before = _build.launch_counts['osa_fused']
    got = osa.fused_osa(x_pad, mask, weights, sh)
    torch.cuda.synchronize()
    assert _build.launch_counts['osa_fused'] == before + 1
    assert_osa_close(got, osa.osa_reference(x_pad, mask, weights, sh), sh)


@pytest.mark.cuda
def test_cuda_osa_negative_bias_zeroes_a_stage(cuda_device):
    sh = OSA_SHAPES['n3_w_much_less_than_wp']
    x_pad, mask, weights = osa_operands(sh, 1, cuda_device, negative_stage=2)
    got = osa.fused_osa(x_pad, mask, weights, sh)
    assert_osa_close(got, osa.osa_reference(x_pad, mask, weights, sh), sh)


@pytest.mark.cuda
def test_cuda_osa_is_bitwise_repeatable(cuda_device):
    """No atomics: tsum is summed per tile and then over the tiles in a
    fixed order. A second call also finds other scratch memory."""
    sh = OSA_SHAPES['cm160_ragged_channel_tile']
    x_pad, mask, weights = osa_operands(sh, 2, cuda_device)
    y1, t1 = osa.fused_osa(x_pad, mask, weights, sh)
    junk = torch.full((64, 2**20), 7.0, device=cuda_device)   # dirty the pool
    del junk
    y2, t2 = osa.fused_osa(x_pad, mask, weights, sh)
    assert torch.equal(y1, y2) and torch.equal(t1, t2)


@pytest.mark.cuda
def test_cuda_osa_refuses_what_the_kernel_does_not_take(cuda_device):
    sh = OSA_SHAPES['n1_w_one_less_than_wp']
    x_pad, mask, weights = osa_operands(sh, 3, cuda_device)
    with pytest.raises(TypeError, match='bfloat16'):
        osa_cuda.osa_fused(x_pad.float(), mask, weights, sh)
    with pytest.raises(TypeError, match='float32'):
        osa_cuda.osa_fused(x_pad, mask, dict(weights, s5=weights['s5'].bfloat16()), sh)
    with pytest.raises(ValueError, match='contiguous'):
        osa_cuda.osa_fused(x_pad, mask, dict(
            weights, w1=weights['w1'].t().contiguous().t()), sh)
    with pytest.raises(ValueError, match='x_pad'):
        osa_cuda.osa_fused(x_pad[:, :-1].contiguous(), mask, weights, sh)
    with pytest.raises(ValueError, match='w \\+ 1'):
        osa_cuda.osa_fused(x_pad, mask, weights, dict(sh, w=16))
    wide = dict(sh, wp=136, h=1)
    with pytest.raises(ValueError, match='halo'):
        osa_cuda.osa_fused(osa.pad_plane(torch.zeros(
            1, 1, 15, 32, dtype=torch.bfloat16, device=cuda_device), 136),
            osa.interior_mask(1, 15, 136, device=cuda_device), weights, wide)
    odd = dict(sh, cm=24)
    with pytest.raises(ValueError):
        osa_cuda.osa_fused(x_pad, mask, weights, odd)


# ----------------------------------------------- the dataset-to-metric path
def _tiny_model(device, seed=0):
    from far3d_tpu_torch.config import tiny_test_config
    from far3d_tpu_torch.entry import build_model
    from far3d_tpu_torch.utils.convert import init_state_dict
    cfg = tiny_test_config()
    return cfg, build_model(cfg, device, weights=init_state_dict(cfg, seed))


@pytest.mark.cuda
def test_cuda_uint8_branch_matches_cpu(cuda_device):
    """uint8 images are normalized on the card to the same bf16 tensor as on
    the CPU (a subtraction and an IEEE f32 division, then one rounding)."""
    from far3d_tpu_torch.models.farhead import init_state
    from far3d_tpu_torch.utils.synthetic import inference_inputs
    cfg, _ = _tiny_model('cpu')
    inputs = {k: torch.from_numpy(v)
              for k, v in inference_inputs(cfg, 1, seed=2).items()}
    inputs['images'] = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, tuple(inputs['images'].shape)).astype(np.uint8))
    seen = {}
    for dev in ('cpu', cuda_device):
        _, model = _tiny_model(dev)
        model.img_backbone.register_forward_pre_hook(
            lambda m, args, dev=str(dev): seen.setdefault(dev, args[0]))
        with torch.inference_mode():
            out = model(state=init_state(1, cfg.head, dev),
                        **{k: v.to(dev) for k, v in inputs.items()})
        assert torch.isfinite(out['all_cls_scores']).all()
    got, want = seen[str(cuda_device)], seen['cpu']
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_run_training_from_disk(cuda_device, tmp_path):
    """Two steps of run_training on the card from a PNG dataset on disk
    (the tiny learnable dataset), crossing the GT-depth switch; each MSDA
    kernel launched 2 x num_layers times; the last step saved."""
    import dataclasses
    import json
    from far3d_tpu_torch.data.av2_dataset import AV2SequenceDataset
    from far3d_tpu_torch.data.loader import TrainLoader
    from far3d_tpu_torch.train.runner import run_training
    from far3d_tpu_torch.utils.checkpoint import CheckpointManager
    from far3d_tpu_torch.utils.synthetic import make_learnable_dataset
    cfg, _ = _tiny_model('cpu')
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, use_gt_depth_until_iter=1, log_every=1,
        checkpoint_every=5))
    ann = str(tmp_path / 'infos.pkl')
    make_learnable_dataset(ann, str(tmp_path), n_scenes=1, frames_per_scene=3)
    loader = TrainLoader(AV2SequenceDataset(ann, str(tmp_path)), cfg, 1,
                         num_threads=2, device=cuda_device)
    names = (msda_cuda.FWD, msda_cuda.DVAL, msda_cuda.DATTN)
    before = {k: _build.launch_counts.get(k, 0) for k in names}
    try:
        state = run_training(cfg, loader, str(tmp_path / 'work'), 1,
                             resume=False, max_iters=2, device=cuda_device)
    finally:
        loader.stop()
    assert state.step == 2
    for k in names:
        assert _build.launch_counts[k] - before[k] == \
            2 * cfg.decoder.num_layers, k
    lines = (tmp_path / 'work' / 'metrics.jsonl').read_text().splitlines()
    assert len(lines) == 2
    assert all(np.isfinite(list(json.loads(x).values())).all() for x in lines)
    assert CheckpointManager(str(tmp_path / 'work')).all_steps() == [2]


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip_is_bitwise(cuda_device, tmp_path):
    from far3d_tpu_torch.train.step import create_train_state, train_step
    from far3d_tpu_torch.utils.checkpoint import CheckpointManager
    from far3d_tpu_torch.utils.synthetic import synthetic_batch
    cfg, model = _tiny_model(cuda_device)
    state, tstate = create_train_state(cfg, model)
    batch = {k: v.to(cuda_device) for k, v in synthetic_batch(cfg, 1).items()}
    state, _, _ = train_step(cfg, state, tstate, batch,
                             torch.Generator().manual_seed(0),
                             torch.Generator(cuda_device).manual_seed(0))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(state.step, state)
    fresh, _ = create_train_state(cfg, _tiny_model(cuda_device, seed=1)[1])
    mgr.restore(fresh)
    assert fresh.step == state.step == 1
    a, b = fresh.model.state_dict(), state.model.state_dict()
    for k in b:
        assert a[k].device == b[k].device and torch.equal(a[k], b[k]), k
    oa, ob = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    assert oa['state'].keys() == ob['state'].keys()
    for i in ob['state']:
        for k in ('step', 'exp_avg', 'exp_avg_sq'):
            x, y = oa['state'][i][k], ob['state'][i][k]
            assert x.device == y.device and torch.equal(x, y), (i, k)
