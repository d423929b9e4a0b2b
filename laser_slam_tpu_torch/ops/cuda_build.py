"""Build the CUDA sources in ``csrc/`` with nvcc and load them via ctypes.

Each source is compiled once per content into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) under
``laser_slam_tpu_torch/_build/``, which git ignores.  The library name
carries a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

# Seconds spent in nvcc per library name during this process (0.0 when a
# previous build was reused).
build_seconds: dict = {}


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, '
                           '/usr/local/cuda/bin and PATH); the CUDA kernels '
                           'are built on the machine that has the card')
    return found


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if needed and return the loaded library."""
    src = os.path.join(CSRC_DIR, source)
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f'lib{stem}_{digest.hexdigest()[:16]}.so')
    if os.path.exists(out):
        build_seconds[source] = 0.0
    else:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{out}.{os.getpid()}.tmp'
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {src}:\n{proc.stdout}\n'
                               f'{proc.stderr}')
        os.replace(tmp, out)
        build_seconds[source] = time.perf_counter() - t0
    return ctypes.CDLL(out)
