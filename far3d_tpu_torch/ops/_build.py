"""Builds the port's CUDA kernels and keeps their launch counts.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout, at its first use in a process,
and loaded with ``ctypes``. A source may include the headers beside it
(``csrc/*.cuh``). The library's file name carries a hash of the source, the
headers and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'kernels'
SOURCES = ('msda_fwd', 'msda_bwd', 'osa_fused', 'qconv',   # every csrc/<name>.cu
           'ese_requant')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# Launches of each kernel in this process; a wrapper adds one where it
# launches its kernel and nowhere else.
launch_counts: Dict[str, int] = {}

# What each build printed (nvcc's -Xptxas -v report) and how long it took.
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for cand in (os.path.join(home, 'bin', 'nvcc'), shutil.which('nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin and PATH); '
                       'the CUDA kernels cannot be built')


def _lib_path(name: str) -> pathlib.Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    headers of ``csrc/`` and the flags."""
    headers = b''.join(h.read_bytes() for h in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes() + headers
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'{name}-{digest}.so'


def load_kernel_libraries(*names: str) -> List[ctypes.CDLL]:
    """Build (if needed) and load ``csrc/<name>.cu`` for each name: one
    ``nvcc`` per source that needs a build, all started together, then each
    waited for. Raises after all have ended if any build failed."""
    builds, failed = [], []
    for name in names:
        if name in _libs:        # loaded: no hash of the sources per call
            continue
        src, lib_path = CSRC / f'{name}.cu', _lib_path(name)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-o', tmp, str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        builds.append((name, src, tmp, lib_path, proc, time.perf_counter()))
    for name, src, tmp, lib_path, proc, t0 in builds:
        build_logs[name] = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f'nvcc failed for {src}:\n{build_logs[name]}')
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError('\n'.join(failed))
    for name in names:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return [_libs[name] for name in names]


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return load_kernel_libraries(name)[0]


def build_all() -> List[ctypes.CDLL]:
    """Build (if needed) and load every kernel source of the port, all nvcc
    runs started together; a failed build of any raises."""
    return load_kernel_libraries(*SOURCES)
