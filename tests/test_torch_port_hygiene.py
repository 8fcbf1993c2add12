"""Import and device hygiene of the PyTorch port: it never loads jax, flax or
the JAX package (nor, from its modules, OpenCV, PIL or pandas, which the
card's machine lacks), and its entry points never quietly fall back to the
CPU."""

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
            'far3d_tpu_torch.ops.qconv_cuda, far3d_tpu_torch.ops.quant, '
            'far3d_tpu_torch.ops.ese_requant_cuda, '
            'far3d_tpu_torch.train.step, far3d_tpu_torch.train.petr_step, '
            'far3d_tpu_torch.models.streampetr, '
            'far3d_tpu_torch.parallel.mesh, '
            'far3d_tpu_torch.parallel.cam_shard, '
            'far3d_tpu_torch.train.matching, far3d_tpu_torch.cli.soak, '
            'far3d_tpu_torch.cli.overfit_full; '
            f'bad = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]; '
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_data_tools_load_neither_jax_nor_pandas():
    """The data-preparation tools and the Feather reader run where the card
    is, which has neither jax nor pandas nor pyarrow."""
    forbidden = FORBIDDEN + ('pandas', 'pyarrow')
    code = ('import sys, far3d_tpu_torch.cli.create_av2_infos, '
            'far3d_tpu_torch.cli.create_nusc_infos, '
            'far3d_tpu_torch.cli.info2coco, far3d_tpu_torch.utils.feather; '
            f'bad = [m for m in sys.modules if m.split(".")[0] in {forbidden!r}]; '
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


def test_init_distributed_without_a_card_raises(monkeypatch):
    """A card asked for (or NCCL) with none present raises: no quiet switch
    to gloo on the CPU."""
    from far3d_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('WORLD_SIZE', '2')
    for kw in ({'device': 'cuda'}, {}, {'device': 'cpu', 'backend': 'nccl'}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.init_distributed(**kw)
    assert mesh.group() is None


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


@pytest.mark.parametrize('name', ['petr_entry', 'petr_train_entry'])
def test_petr_entries_without_a_card_raise(monkeypatch, name):
    import far3d_tpu_torch.entry as entry_mod
    from far3d_tpu_torch.models.streampetr import tiny_petr_config
    with _no_card(monkeypatch):
        getattr(entry_mod, name)(tiny_petr_config())


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


def test_qconv_cuda_wrapper_refuses_cpu_tensors():
    """`qconv_cuda.qconv_cuda` never computes on the CPU (the dispatcher
    `qconv` is what routes CPU tensors to `qconv_reference`)."""
    from far3d_tpu_torch.ops.qconv_cuda import qconv_cuda
    x = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    w = torch.zeros(8, 3, 3, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match='CUDA'):
        qconv_cuda(x, w, torch.ones(8), torch.zeros(8))


def test_ese_requant_cuda_wrapper_refuses_cpu_tensors():
    """`ese_requant_cuda.ese_requant_cuda` never computes on the CPU (the
    dispatcher `quant.ese_requant` is what routes CPU tensors to
    `ese_requant_reference`)."""
    from far3d_tpu_torch.ops.ese_requant_cuda import ese_requant_cuda
    y = torch.zeros(1, 2, 3, 16)
    with pytest.raises(ValueError, match='CUDA'):
        ese_requant_cuda(y, torch.zeros(1, 16), torch.tensor(1.0))


def _port_modules():
    return sorted('.'.join(p.relative_to(ROOT).with_suffix('').parts)
                  for p in (ROOT / 'far3d_tpu_torch').rglob('*.py')
                  if p.name != '__init__.py')


def test_every_module_loads_no_jax_opencv_pil_or_pandas():
    mods = _port_modules()
    assert 'far3d_tpu_torch.data.image_io' in mods
    forbidden = FORBIDDEN + ('cv2', 'PIL', 'pandas')
    code = ('import importlib, sys\n'
            f'for m in {mods!r}: importlib.import_module(m)\n'
            f'bad = [m for m in sys.modules if m.split(".")[0] in {forbidden!r}]\n'
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    return pytest.raises(RuntimeError, match="device='cpu'")


def test_run_training_without_a_card_raises(monkeypatch, tmp_path):
    from far3d_tpu_torch.config import tiny_test_config
    from far3d_tpu_torch.train.runner import run_training
    with _no_card(monkeypatch):
        run_training(tiny_test_config(), iter(()), str(tmp_path), 1)


def test_run_inference_petr_without_a_card_raises(monkeypatch):
    from far3d_tpu_torch.entry import build_petr_model
    from far3d_tpu_torch.eval.petr_runner import run_inference_petr
    from far3d_tpu_torch.models.streampetr import tiny_petr_config
    cfg = tiny_petr_config()
    model = build_petr_model(cfg, 'cpu')
    with _no_card(monkeypatch):
        run_inference_petr(cfg, model, [])


def test_run_inference_without_a_card_raises(monkeypatch):
    from far3d_tpu_torch.config import tiny_test_config
    from far3d_tpu_torch.entry import build_model
    from far3d_tpu_torch.eval.runner import run_inference
    cfg = tiny_test_config()
    model = build_model(cfg, 'cpu')
    with _no_card(monkeypatch):
        run_inference(cfg, model, [])


@pytest.mark.parametrize('cli,argv', [
    ('train', ['--data-root', 'missing', '--tiny']),
    ('test', ['--data-root', 'missing', '--checkpoint', 'missing', '--tiny']),
    ('overfit_demo', ['--work', 'missing', '--iters', '1']),
    ('quant_accuracy', ['--work', 'missing', '--iters', '1']),
    ('train_nusc', ['--data-root', 'missing', '--tiny']),
    ('test_nusc', ['--data-root', 'missing', '--random-init', '--tiny']),
    ('overfit_nusc_demo', ['--work', 'missing', '--iters', '1']),
    ('quant_accuracy_nusc', ['--work', 'missing', '--iters', '1'])])
def test_cli_without_a_card_raises(monkeypatch, tmp_path, cli, argv):
    import importlib
    main = importlib.import_module(f'far3d_tpu_torch.cli.{cli}').main
    monkeypatch.chdir(tmp_path)
    with _no_card(monkeypatch):
        main(argv)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize('loader', ['TrainLoader', 'EvalLoader'])
def test_loader_without_a_card_raises(monkeypatch, loader):
    from far3d_tpu_torch.config import tiny_test_config
    from far3d_tpu_torch.data import loader as mod

    class Empty:
        flag = [0]

        def __len__(self):
            return 1

    args = (Empty(), tiny_test_config()) + ((1,) if loader == 'TrainLoader'
                                            else ())
    with _no_card(monkeypatch):
        getattr(mod, loader)(*args)
