"""Import and device hygiene of the PyTorch port: it never loads jax, flax or
the JAX package, and its entry point never quietly falls back to the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'far3d_tpu')


def test_import_loads_no_jax():
    code = ('import sys, far3d_tpu_torch, far3d_tpu_torch.entry, '
            'far3d_tpu_torch.ops.msda_cuda, far3d_tpu_torch.ops.osa_cuda, '
            'far3d_tpu_torch.train.step; '
            f'bad = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]; '
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / 'far3d_tpu_torch').rglob('*.py')]
    + ['chip_smoke.py', 'tools/profile_torch_port.py',
       'tools/micro_osa_torch.py']))
def test_source_imports_no_jax(path):
    roots = set(_imported_roots(ROOT / path))
    assert not roots & set(FORBIDDEN), (path, sorted(roots & set(FORBIDDEN)))


def test_entry_without_a_card_raises(monkeypatch):
    from far3d_tpu_torch.config import tiny_test_config
    from far3d_tpu_torch.entry import entry
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(tiny_test_config())


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: a CPU tensor is an
    error there (the dispatcher `msda` is what routes CPU tensors to the
    plain version)."""
    from far3d_tpu_torch.ops.msda_cuda import msda_fwd
    v = torch.zeros(1, 4, 8)
    loc = torch.zeros(1, 2, 3, 2)
    w = torch.zeros(1, 2, 2, 1, 3)
    with pytest.raises(ValueError, match='CUDA'):
        msda_fwd(v, [(2, 2)], loc, w)


def test_cuda_backward_wrappers_refuse_cpu_tensors():
    from far3d_tpu_torch.ops.msda_cuda import msda_dattn, msda_dval
    v = torch.zeros(1, 4, 8)
    loc = torch.zeros(1, 2, 3, 2)
    w = torch.zeros(1, 2, 2, 1, 3)
    g = torch.zeros(1, 2, 8)
    for fn in (msda_dval, msda_dattn):
        with pytest.raises(ValueError, match='CUDA'):
            fn(v, [(2, 2)], loc, w, g)


def test_train_entry_without_a_card_raises(monkeypatch):
    from far3d_tpu_torch.config import tiny_test_config
    from far3d_tpu_torch.entry import train_entry
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_entry(tiny_test_config())


def test_osa_cuda_wrapper_refuses_cpu_tensors():
    """`osa_cuda.osa_fused` never computes on the CPU (the dispatcher
    `fused_osa` is what routes CPU tensors to `osa_reference`)."""
    from far3d_tpu_torch.ops import osa
    from far3d_tpu_torch.ops.osa_cuda import osa_fused
    sh = dict(h=2, w=3, wp=4, cin=16, cm=16, cout=16)
    bf16 = dict(dtype=torch.bfloat16)
    weights = dict(w1=torch.zeros(9 * 16, 16, **bf16),
                   w2345=torch.zeros(4 * 9 * 16, 16, **bf16),
                   wcat=torch.zeros(16 + 5 * 16, 16, **bf16),
                   s5=torch.ones(5, 16), b5=torch.zeros(5, 16),
                   sc=torch.ones(1, 16), bc=torch.zeros(1, 16))
    x_pad = osa.pad_plane(torch.zeros(1, 2, 3, 16, **bf16), sh['wp'])
    with pytest.raises(ValueError, match='CUDA'):
        osa_fused(x_pad, osa.interior_mask(2, 3, 4), weights, sh)
