"""The ViT's SwiGLU tail (``models/vit.py:swiglu_tail``; on the card the
kernel of ``csrc/swiglu_tail.cu`` behind ``ops/swiglu_cuda.py``).

On the CPU: ``SwiGLU.forward`` through the dispatch is bitwise the
composite it runs in place of, in float32 and bf16; the plain tail writes
exact zeros in the padded channels; the wrapper's checks refuse each input
outside its contract, by name. On the card (``cuda`` marker; skipped
without one): the kernel against the plain tail at the cell's shape and at
ragged small ones, repeatable bitwise, in a CUDA graph's replay too, one
launch a call. This file imports no jax; on the card:

    python -m pytest --noconftest tests/test_torch_port_swiglu.py -q
"""

import pytest
import torch
import torch.nn.functional as F

from far3d_tpu_torch.models import vit
from far3d_tpu_torch.ops import _build, swiglu_cuda

EPS = 1e-6
# (rows, hid): the cell's tail (6 cameras of 50 x 100 tokens, EVA-02-L's
# 2,730) and ragged small ones (the tiny ViT's 170, a width that is a
# multiple of 8, rows that fill no wave)
CARD_SHAPES = [(30000, 2730), (37, 170), (5, 2736), (1, 8)]


def _composite(mod: vit.SwiGLU, x: torch.Tensor) -> torch.Tensor:
    """``SwiGLU.forward`` as it ran before the dispatch: the tail as
    PyTorch passes (SiLU, the gate product, ``ffn_ln``, the pad)."""
    hid = mod.w1.out_features
    pad = -hid % 8
    w12 = torch.cat([F.pad(mod.w1.weight, (0, 0, 0, pad)),
                     F.pad(mod.w2.weight, (0, 0, 0, pad))]).to(x.dtype)
    b12 = torch.cat([F.pad(mod.w1.bias, (0, pad)),
                     F.pad(mod.w2.bias, (0, pad))]).to(x.dtype)
    a, g = F.linear(x, w12, b12).split(hid + pad, dim=-1)
    h = mod.ffn_ln(F.silu(a[..., :hid]) * g[..., :hid])
    return F.linear(F.pad(h, (0, pad)),
                    F.pad(mod.w3.weight, (0, pad)).to(x.dtype),
                    mod.w3.bias.to(x.dtype))


def _seeded_swiglu(hid: int, width: int = 64) -> vit.SwiGLU:
    mod = vit.SwiGLU(vit.ViTConfig(embed_dim=width, mlp_hidden_dim=hid))
    gen = torch.Generator().manual_seed(hid)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
        mod.ffn_ln.weight.add_(1)
    return mod.eval()


def _operands(rows: int, hid: int, dtype, device='cpu', seed=0):
    """ag (rows, 2 W) with nonzero padded channels (the kernel must not
    read them into the result), ffn_ln's weight and bias."""
    width = hid + -hid % 8
    gen = torch.Generator().manual_seed(seed)
    ag = torch.randn(rows, 2 * width, generator=gen) * 2
    weight = 1 + 0.1 * torch.randn(hid, generator=gen)
    bias = 0.1 * torch.randn(hid, generator=gen)
    return [t.to(device=device, dtype=dtype) for t in (ag, weight, bias)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hid', [170, 2730, 176])
@torch.no_grad()
def test_the_dispatch_is_bitwise_the_composite_on_the_cpu(dtype, hid):
    mod = _seeded_swiglu(hid)
    x = torch.randn(2, 3, 5, 64, generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    got, want = mod(x), _composite(mod, x)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize('hid', [170, 2730, 176, 1])
def test_the_plain_tail_leaves_the_padded_channels_zero(hid):
    ag, weight, bias = _operands(7, hid, torch.bfloat16)
    width = ag.shape[-1] // 2
    assert ag[:, hid:width].abs().sum() > 0 or hid == width
    out = vit.swiglu_tail(ag, weight, bias, EPS)
    assert out.shape == (7, width) and out.dtype == torch.bfloat16
    assert torch.equal(out[:, hid:], torch.zeros(7, width - hid,
                                                 dtype=torch.bfloat16))
    want = F.layer_norm(F.silu(ag[:, :hid]) * ag[:, width:width + hid],
                        (hid,), weight, bias, EPS)
    assert torch.equal(out[:, :hid], want)


def _wider(ag):
    """ag as a column slice of rows 4 elements wider (8 bytes in bf16)."""
    buf = torch.zeros(ag.shape[0], ag.shape[1] + 4, dtype=ag.dtype)
    buf[:, :ag.shape[1]] = ag
    return buf[:, :ag.shape[1]]


# name -> (make the operands from good ones, what the message names)
REFUSALS = {
    'ag_float16': (lambda ag, w, b: (ag.half(), w, b), 'ag must be'),
    'weight_dtype': (lambda ag, w, b: (ag, w.float(), b), 'weight must be'),
    'bias_dtype': (lambda ag, w, b: (ag, w, b.float()), 'bias must be'),
    'ag_unpadded_width': (lambda ag, w, b: (ag[:, :2 * 170], w, b),
                          r'ag must be \(\.\.\., 352\)'),
    'bias_width': (lambda ag, w, b: (ag, w, b[:169].clone()), 'bias has'),
    'ag_pitch': (lambda ag, w, b: (_wider(ag), w, b),
                 'ag .* not contiguous'),
    'ag_misaligned': (lambda ag, w, b: (
        torch.cat([ag.new_zeros(8), ag.flatten()])[4:4 + ag.numel()]
        .view(ag.shape), w, b), 'ag must be 16-byte aligned'),
    'ag_transposed': (lambda ag, w, b: (ag.t().contiguous().t(), w, b),
                      'ag .* not contiguous'),
    'ag_rows_uneven': (lambda ag, w, b: (
        ag.view(2, 2, -1).transpose(0, 1), w, b), 'ag .* not contiguous'),
    'weight_strided': (lambda ag, w, b: (
        ag, w.repeat_interleave(2)[::2], b), 'weight must be a contiguous'),
    'ag_needs_grad': (lambda ag, w, b: (ag.requires_grad_(), w, b),
                      'ag requires grad'),
    'weight_needs_grad': (lambda ag, w, b: (ag, w.requires_grad_(), b),
                          'weight requires grad'),
}


@pytest.mark.parametrize('name', sorted(REFUSALS))
def test_the_wrapper_refuses_by_name(name):
    make, message = REFUSALS[name]
    ag, weight, bias = make(*_operands(4, 170, torch.bfloat16))
    with pytest.raises(ValueError, match=message):
        swiglu_cuda.check_args(ag, weight, bias)


def test_the_wrapper_takes_the_cell_shape():
    ag, weight, bias = (torch.empty(s, dtype=torch.bfloat16, device='meta')
                        for s in ((6, 50, 100, 5472), (2730,), (2730,)))
    assert swiglu_cuda.check_args(ag, weight, bias) == (30000, 2730)
    ag, weight, bias = _operands(4, 170, torch.bfloat16)
    with torch.no_grad():     # nothing to record: a parameter is taken
        assert swiglu_cuda.check_args(ag, weight.requires_grad_(), bias) == \
            (4, 170)


def test_the_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        swiglu_cuda.swiglu_tail_cuda(*_operands(4, 170, torch.bfloat16), EPS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (the CUDA kernel has no CPU mode)')
    return torch.device('cuda')


def _assert_close(got, want, hid):
    """The kernel's mean and variance sum in another order than PyTorch's
    LayerNorm (two passes over the row in registers against Welford's), so
    an output may round one step apart: at most one bf16 step of the larger
    of its magnitude and 2^-6 (a result near zero keeps the float32 error
    of terms near one), and 1e-5 of that in float32."""
    d = (got[..., :hid].double() - want[..., :hid].double()).abs()
    mag = torch.maximum(want[..., :hid].double().abs(),
                        torch.tensor(2.0 ** -6, dtype=torch.float64,
                                     device=want.device))
    if got.dtype == torch.bfloat16:
        step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    else:
        step = 1e-5 * mag
    worst = float((d / step).max())
    assert worst <= 1.0, f'{worst:.3f} steps apart'


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('rows,hid', CARD_SHAPES)
def test_the_kernel_is_the_plain_tail_on_the_card(rows, hid, dtype,
                                                  cuda_device):
    ag, weight, bias = _operands(rows, hid, dtype, cuda_device, seed=rows)
    width = ag.shape[-1] // 2
    before = _build.launch_counts.get(swiglu_cuda.NAME, 0)
    got = vit.swiglu_tail(ag, weight, bias, EPS)
    again = vit.swiglu_tail(ag, weight, bias, EPS)
    torch.cuda.synchronize()
    assert _build.launch_counts[swiglu_cuda.NAME] == before + 2
    want = vit.swiglu_tail_reference(ag, weight, bias, EPS)
    assert got.shape == want.shape == (rows, width) and got.dtype == dtype
    assert torch.equal(got[:, hid:], torch.zeros_like(got[:, hid:]))
    _assert_close(got, want, hid)
    assert torch.equal(got, again)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        vit.swiglu_tail(ag, weight, bias, EPS)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = vit.swiglu_tail(ag, weight, bias, EPS)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)
    assert _build.launch_counts[swiglu_cuda.NAME] == before + 4


@pytest.mark.cuda
def test_a_model_block_runs_the_kernel_on_the_card(cuda_device):
    """``SwiGLU.forward`` in bf16 under inference mode goes through the
    kernel, once a call, within the tolerance of the composite; with
    autograd recording it raises."""
    mod = _seeded_swiglu(2730, 1024).to(cuda_device)
    x = torch.randn(2, 5, 7, 1024, device=cuda_device, dtype=torch.bfloat16)
    before = _build.launch_counts.get(swiglu_cuda.NAME, 0)
    with torch.inference_mode():
        got = mod(x)
    assert _build.launch_counts[swiglu_cuda.NAME] == before + 1
    with torch.inference_mode():
        want = _composite(mod, x)
    rel = float((got.double() - want.double()).norm() / want.double().norm())
    assert rel < 2.0 ** -8, rel
    with pytest.raises(ValueError, match='requires grad'):
        mod(x)

