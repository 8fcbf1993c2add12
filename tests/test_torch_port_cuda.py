"""The hand-written CUDA MSDA kernels (forward, and the two backward
kernels through autograd) against their plain PyTorch versions, on the
card. These tests import neither jax nor the JAX package, and skip where
there is no card. On a machine with a card and without jax:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from _msda_cases import CASES
from far3d_tpu_torch.ops import _build, msda_cuda
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
    plain version, f32: atomics and shuffles sum in another order, 1e-5."""
    v, shapes, l, w, g = _backward_case(case, cuda_device)
    got = _kernel_grads(v, shapes, l, w, g)
    want = msda_backward_reference(v, shapes, l, w, g)
    for name, a, b in zip(('d_value', 'd_loc', 'd_weights'), got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
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
