"""The port's MSDA (far3d_tpu_torch/ops/msda.py) against the JAX package.

`msda_reference`, the plain PyTorch version that serves CPU tensors and is the
card kernel's yardstick, is held to `msda_xla` at 1e-4 (f32, same algorithm),
to the Pallas kernel in interpret mode at 2e-2 (the kernel rounds its one-hot
weights and weighted rows to bf16, msda_pallas.py:182,202-204), and its
autograd gradients to `jax.vjp(msda_xla)` at 1e-4. The CUDA kernel is held to
the plain version on the card in tests/test_torch_port_cuda.py.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _msda_cases import CASES, _case
from far3d_tpu.ops.msda import msda_xla
from far3d_tpu_torch.ops import _build
from far3d_tpu_torch.ops.msda import msda, msda_reference


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('case', sorted(CASES))
def test_reference_matches_msda_xla(case):
    value, shapes, loc, weights = CASES[case]()
    want = np.asarray(msda_xla(jnp.asarray(value), shapes, jnp.asarray(loc),
                               jnp.asarray(weights)))
    v, l, w = _t(value, loc, weights)
    got = msda_reference(v, shapes, l, w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if case == 'outside':
        assert not got.any()     # every corner out of bounds -> exact zeros


def test_reference_matches_pallas_interpret():
    from jax.experimental import pallas as pl
    from far3d_tpu.ops import msda_pallas as mp

    value, shapes, loc, weights = _case(4, -0.2, 1.2, shapes=((6, 8), (3, 4)))
    orig_call = pl.pallas_call

    def interp_call(*a, **k):
        k['interpret'] = True
        return orig_call(*a, **k)

    mp._clear_kernel_caches()
    with mock.patch.object(mp.pl, 'pallas_call', interp_call):
        want = np.asarray(mp.msda_pallas(jnp.asarray(value), tuple(shapes),
                                         jnp.asarray(loc),
                                         jnp.asarray(weights)))
    mp._clear_kernel_caches()
    got = msda_reference(*_t(value), shapes, *_t(loc, weights)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize('case', ['in_bounds', 'mixed'])
def test_reference_gradients_match_msda_xla_vjp(case):
    value, shapes, loc, weights = CASES[case]()
    g_out = np.random.RandomState(7).randn(
        value.shape[0], loc.shape[1], value.shape[2]).astype(np.float32)
    _, vjp = jax.vjp(lambda v, l, w: msda_xla(v, shapes, l, w),
                     jnp.asarray(value), jnp.asarray(loc),
                     jnp.asarray(weights))
    want = [np.asarray(g) for g in vjp(jnp.asarray(g_out))]

    v, l, w = [t.requires_grad_() for t in _t(value, loc, weights)]
    msda_reference(v, shapes, l, w).backward(torch.from_numpy(g_out))
    for name, got, ref in zip(('value', 'loc', 'weights'),
                              (v.grad, l.grad, w.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4,
                                   err_msg=f'd_{name}')


def test_cpu_dispatch_takes_the_plain_version():
    value, shapes, loc, weights = CASES['mixed']()
    from far3d_tpu_torch.ops import msda_cuda  # noqa: F401  registers the count
    before = dict(_build.launch_counts)
    got = msda(*_t(value), shapes, *_t(loc, weights))
    assert _build.launch_counts == before
    assert _build.launch_counts['msda_fwd'] == 0
    want = msda_reference(*_t(value), shapes, *_t(loc, weights))
    assert torch.equal(got, want)
