"""Builds the port's CUDA kernels and keeps their launch counts.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout, at its first use in a process,
and loaded with ``ctypes``. The library's file name carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused. A missing ``nvcc`` or a failed build raises.
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
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'kernels'
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


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    lib_path = BUILD_DIR / f'{name}-{digest}.so'
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, str(src)],
                              capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f'nvcc failed for {src}:\n{build_logs[name]}')
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _libs[name] = lib
    return lib
