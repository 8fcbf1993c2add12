"""The hand-written CUDA MSDA kernel against its plain PyTorch version, on
the card. These tests import neither jax nor the JAX package, and skip where
there is no card. On a machine with a card and without jax:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from _msda_cases import CASES
from far3d_tpu_torch.ops import _build
from far3d_tpu_torch.ops.msda import msda, msda_reference


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


@pytest.mark.cuda
def test_cuda_backward_raises(cuda_device):
    value, shapes, loc, weights = CASES['in_bounds']()
    v = torch.from_numpy(value).to(cuda_device).requires_grad_()
    l, w = [torch.from_numpy(a).to(cuda_device) for a in (loc, weights)]
    with pytest.raises(NotImplementedError, match='training slice'):
        msda(v, shapes, l, w).sum().backward()
