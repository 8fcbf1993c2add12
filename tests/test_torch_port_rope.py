"""The ViT's 2D rotary embedding of q and k (``models/vit.py:rope``; on the
card the kernel of ``csrc/vit_rope.cu`` behind ``ops/rope_cuda.py``).

On the CPU: the dispatch is bitwise the three-pass composite it runs in
place of (``x * cos``, the pair swap's ``flip``, ``addcmul``), in float32
and bf16, on a ``qkv[:2]`` view of a windowed and of a global block's
shape; the wrapper's output has the composite's strides on that view, so
the attention reads the layout it read before; the wrapper's checks refuse
each input outside its contract, by name, and CPU tensors. On the card
(``cuda`` marker; skipped without one): the kernel against the plain
version at the ViT cell's two shapes and at ragged small ones, no farther
than the plain version from the exact rotation, repeatable bitwise, in a
CUDA graph's replay too, one launch a call. This file imports no jax; on
the card:

    python -m pytest --noconftest tests/test_torch_port_rope.py -q
"""

import pytest
import torch

from far3d_tpu_torch.models import vit
from far3d_tpu_torch.ops import _build, rope_cuda

GRID, THETA = 16, 10000.0
# (B, (rows, cols), heads, head width): the ViT cell's windowed blocks (6
# cameras of 4 x 7 windows of 16 x 16) and global ones (6 cameras of 50 x
# 100), then ragged small ones (one vector a row; a head width of three
# vectors; heads and tokens that fill no block)
CELL_SHAPES = [(168, (16, 16), 16, 64), (6, (50, 100), 16, 64)]
SMALL_SHAPES = [(1, (1, 1), 1, 8), (3, (1, 37), 2, 24), (5, (7, 1), 3, 16)]
# the CPU's, at the tiny ViT's width: 4 x 4 windows, a 4 x 6 global grid
CPU_SHAPES = [(8, (4, 4), 4, 16), (2, (4, 6), 4, 16)]


def _composite(x, cos, sin):
    """``rope`` as the port ran it before the kernel: three PyTorch passes
    over the strided view."""
    swapped = x.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return torch.addcmul(x * cos, swapped, sin)


def _operands(shape, dtype, device='cpu', seed=0):
    """q and k as the view ``qkv[:2]`` of a seeded (B, S, 3 C) product, as
    ``Attention.forward`` takes them, and the grid's tables."""
    b, (rows, cols), nh, d = shape
    gen = torch.Generator().manual_seed(seed)
    qkv = 2 * torch.randn(b, rows * cols, 3 * nh * d, generator=gen)
    qkv = qkv.to(device=device, dtype=dtype)
    x = qkv.view(b, rows * cols, 3, nh, d).permute(2, 0, 3, 1, 4)[:2]
    cos, sin = vit.rope_tables(rows, cols, d, GRID, THETA, device, dtype)
    return x, cos, sin


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', CPU_SHAPES, ids=['window', 'global'])
def test_the_dispatch_is_bitwise_the_composite_on_the_cpu(dtype, shape):
    x, cos, sin = _operands(shape, dtype)
    got, want = vit.rope(x, cos, sin), _composite(x, cos, sin)
    assert got.dtype == want.dtype == dtype
    assert got.stride() == want.stride()
    assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', CPU_SHAPES + CELL_SHAPES,
                         ids=['window', 'global', 'cell_window',
                              'cell_global'])
def test_the_wrapper_writes_the_composites_layout(dtype, shape):
    """On the ``qkv[:2]`` view the kernel's output takes the strides the
    composite's output has, (B, S, 2, H, D) in memory: the attention's
    inputs keep their layout."""
    b, (rows, cols), nh, d = shape
    qkv = torch.empty(b, rows * cols, 3 * nh * d, dtype=dtype, device='meta')
    x = qkv.view(b, rows * cols, 3, nh, d).permute(2, 0, 3, 1, 4)[:2]
    table = torch.empty(rows * cols, d, dtype=dtype, device='meta')
    out = rope_cuda.out_like(x)
    assert out.shape == x.shape and out.dtype == dtype
    assert out.stride() == _composite(x, table, table).stride()


def test_the_wrapper_takes_the_cell_shapes():
    for shape, total in zip(CELL_SHAPES, (11_010_048, 7_680_000)):
        b, (rows, cols), nh, d = shape
        x, cos, sin = (
            torch.empty(s, dtype=torch.bfloat16, device='meta')
            for s in ((2, b, nh, rows * cols, d), (rows * cols, d),
                      (rows * cols, d)))
        assert rope_cuda.check_args(x, cos, sin) == (total, 8)
    x, cos, sin = _operands(CPU_SHAPES[0], torch.float32)
    assert rope_cuda.check_args(x, cos, sin) == (2 * 8 * 4 * 16 * 4, 4)
    with torch.no_grad():     # nothing to record: a table is taken
        assert rope_cuda.check_args(x, cos.clone().requires_grad_(),
                                    sin)[1] == 4


def _shifted(t):
    """t's values 8 bytes into a fresh buffer (in bf16): misaligned."""
    return torch.cat([t.new_zeros(8), t.flatten()])[4:4 + t.numel()] \
        .view(t.shape)


def _pitched(x):
    """x as the view of a qkv product whose rows are 4 elements wider (8
    bytes in bf16)."""
    _, b, nh, s, d = x.shape
    buf = torch.zeros(b, s, 3 * nh * d + 4, dtype=x.dtype)
    return buf[..., :3 * nh * d].view(b, s, 3, nh, d).permute(2, 0, 3, 1,
                                                             4)[:2]


def _head_width(x, d):
    """Operands like x's with a head width of d."""
    s = x.shape[-2]
    return (torch.zeros(*x.shape[:-1], d, dtype=x.dtype),
            torch.zeros(s, d, dtype=x.dtype), torch.zeros(s, d, dtype=x.dtype))


# name -> (make the operands from good ones, what the message names)
REFUSALS = {
    'x_float16': (lambda x, c, s: (x.half(), c, s), 'x must be bfloat16'),
    'cos_dtype': (lambda x, c, s: (x, c.float(), s), 'cos must be'),
    'sin_dtype': (lambda x, c, s: (x, c, s.float()), 'sin must be'),
    'x_four_dims': (lambda x, c, s: (x[0], c, s), r'x must be \(G, B'),
    'head_width_12': (lambda x, c, s: _head_width(x, 12),
                      'D = 12 must be a multiple of 8'),
    'x_last_stride': (lambda x, c, s: (
        x.transpose(-1, -2).contiguous().transpose(-1, -2), c, s),
        'last-dim stride other than 1'),
    'x_misaligned': (lambda x, c, s: (_shifted(x), c, s),
                     'x must be 16-byte aligned'),
    'x_rows_misaligned': (lambda x, c, s: (_pitched(x), c, s),
                          'rows of x .* not 16-byte aligned'),
    'cos_shape': (lambda x, c, s: (x, c[:-1], s), r'cos must be \(S, D\)'),
    'sin_shape': (lambda x, c, s: (x, c, s[:, :8].contiguous()),
                  r'sin must be \(S, D\)'),
    'cos_strided': (lambda x, c, s: (x, c.t().contiguous().t(), s),
                    'cos .* not contiguous'),
    'sin_misaligned': (lambda x, c, s: (x, c, _shifted(s)),
                       'sin must be 16-byte aligned'),
    'x_needs_grad': (lambda x, c, s: (x.detach().requires_grad_(), c, s),
                     'x requires grad'),
    'sin_needs_grad': (lambda x, c, s: (x, c, s.clone().requires_grad_()),
                       'sin requires grad'),
}


@pytest.mark.parametrize('name', sorted(REFUSALS))
def test_the_wrapper_refuses_by_name(name):
    make, message = REFUSALS[name]
    x, cos, sin = make(*_operands(CPU_SHAPES[0], torch.bfloat16))
    with pytest.raises(ValueError, match=message):
        rope_cuda.check_args(x, cos, sin)


def test_the_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        rope_cuda.rope_cuda(*_operands(CPU_SHAPES[0], torch.bfloat16))
    x, cos, sin = _operands(CPU_SHAPES[0], torch.bfloat16)
    with pytest.raises(ValueError, match='one CUDA device'):
        rope_cuda.rope_cuda(x, cos.to('meta'), sin)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (the CUDA kernel has no CPU mode)')
    return torch.device('cuda')


def _terms(x, cos, sin):
    """The two products of each output, x * cos and swap(x) * sin, in
    float64."""
    x, cos, sin = x.double(), cos.double(), sin.double()
    return x * cos, x.unflatten(-1, (-1, 2)).flip(-1).flatten(-2) * sin


def _assert_close(got, want, x, cos, sin):
    """The kernel rounds once where the composite rounds ``x * cos`` before
    the add, so an output may lie a step apart: at most one step (bf16, or
    two float32 ulps) of the larger of the output's and its two products'
    magnitudes (a near-cancelling pair keeps the rounding of its terms)."""
    a, b = _terms(x, cos, sin)
    mag = torch.maximum(want.double().abs(),
                        torch.maximum(a.abs(), b.abs())).clamp_min(2.0 ** -60)
    mantissa = 7 if got.dtype == torch.bfloat16 else 22
    # the power of two at or below mag from its exponent bits: the card's
    # float64 log2 of a power of two may fall below the integer
    step = (mag.view(torch.int64) & -2 ** 52).view(torch.float64) \
        * 2.0 ** -mantissa
    worst = float(((got.double() - want.double()).abs() / step).max())
    assert worst <= 1.0, f'{worst:.3f} steps apart'


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', CELL_SHAPES + SMALL_SHAPES)
def test_the_kernel_is_the_plain_version_on_the_card(shape, dtype,
                                                     cuda_device):
    x, cos, sin = _operands(shape, dtype, cuda_device, seed=shape[0])
    before = _build.launch_counts.get(rope_cuda.NAME, 0)
    got = vit.rope(x, cos, sin)
    again = vit.rope(x, cos, sin)
    torch.cuda.synchronize()
    assert _build.launch_counts[rope_cuda.NAME] == before + 2
    want = vit.rope_reference(x, cos, sin)
    assert got.shape == want.shape and got.dtype == dtype
    assert got.stride() == want.stride()
    _assert_close(got, want, x, cos, sin)
    assert torch.equal(got, again)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        vit.rope(x, cos, sin)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = vit.rope(x, cos, sin)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)
    assert _build.launch_counts[rope_cuda.NAME] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_the_kernel_takes_any_aligned_strides_on_the_card(dtype,
                                                          cuda_device):
    """A contiguous x, the view of a product with 8 spare elements a row,
    and k and v (a view that starts inside the product): the kernel
    follows the pointer and strides it is given."""
    x, cos, sin = _operands(SMALL_SHAPES[1], dtype, cuda_device, seed=9)
    _, b, nh, s, d = x.shape
    buf = torch.randn(b, s, 3 * nh * d + 8, device=cuda_device).to(dtype)
    qkv = buf[..., :3 * nh * d].view(b, s, 3, nh, d).permute(2, 0, 3, 1, 4)
    for v in (x.contiguous(), qkv[:2], qkv[1:]):
        _assert_close(rope_cuda.rope_cuda(v, cos, sin),
                      vit.rope_reference(v, cos, sin), v, cos, sin)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', CELL_SHAPES, ids=['window', 'global'])
def test_the_kernel_is_no_farther_from_the_exact_rotation(shape,
                                                         cuda_device):
    """In bf16, at the cell's shapes: against the rotation of the same bf16
    inputs in float64, the kernel's largest error and its error's norm are
    no larger than the plain version's."""
    x, cos, sin = _operands(shape, torch.bfloat16, cuda_device, seed=3)
    a, b = _terms(x, cos, sin)
    exact = a + b
    del a, b
    err_k = (rope_cuda.rope_cuda(x, cos, sin).double() - exact).abs()
    err_p = (vit.rope_reference(x, cos, sin).double() - exact).abs()
    assert float(err_k.max()) <= float(err_p.max())
    assert float(err_k.norm()) <= float(err_p.norm())


@pytest.mark.cuda
def test_a_model_attention_runs_the_kernel_on_the_card(cuda_device,
                                                       monkeypatch):
    """``Attention.forward`` in bf16 under inference mode goes through the
    kernel, once a call; its output lies nearer the composite's than the
    composite's own lies to the float32 module's (the two differ by the
    rotation's bf16 rounding, which the softmax and ``inner_attn_ln``
    carry on at the size of the module's other bf16 roundings); with
    autograd recording it raises."""
    cfg = vit.ViTConfig(embed_dim=256, num_heads=4)
    attn = vit.Attention(cfg)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        attn.inner_attn_ln.weight.add_(1)
    attn = attn.to(cuda_device)
    x = torch.randn(3, 5, 7, 256, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
    before = _build.launch_counts.get(rope_cuda.NAME, 0)
    with torch.inference_mode():
        got = attn(x)
    assert _build.launch_counts[rope_cuda.NAME] == before + 1
    with torch.inference_mode():
        monkeypatch.setattr(vit, 'rope', _composite)
        want, exact = attn(x), attn(x.float())
        monkeypatch.undo()

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    assert rel(got, want) < rel(want, exact), (rel(got, want),
                                               rel(want, exact))
    with pytest.raises(ValueError, match='requires grad'):
        attn(x)
