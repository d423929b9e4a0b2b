"""Build the CUDA sources in ``csrc/`` with nvcc and load them via ctypes.

Each source is compiled once per content into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) under
``laser_slam_tpu_torch/_build/``, which git ignores.  The library name
carries a hash of the source, of every header in ``csrc/`` (``*.cuh``,
which the sources include) and of the flags, so an edited source or
header builds anew and an unchanged one is reused.  Nothing here runs at import time.
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

# Seconds from the start of a build() call until nvcc finished each
# source, per source name (0.0 when a previous build was reused).
build_seconds: dict = {}

# The sources every ICP on the card loads (the matcher's kernels, the GN
# stage's): the first load of either builds both, side by side, so a
# fresh checkout pays one nvcc wait instead of two in a row.
BUILT_TOGETHER = ('nn.cu', 'icp.cu')


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


def _library_path(source: str) -> tuple:
    """(source path, library path) of ``csrc/<source>``."""
    src = os.path.join(CSRC_DIR, source)
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith('.cuh'))
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, 'rb') as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return src, os.path.join(BUILD_DIR,
                             f'lib{stem}_{digest.hexdigest()[:16]}.so')


def build(sources) -> None:
    """Compile every ``csrc/<source>`` whose library is missing, one nvcc
    process per source, all started together."""
    jobs = []
    t0 = time.perf_counter()
    for source in sources:
        src, out = _library_path(source)
        if os.path.exists(out):
            build_seconds.setdefault(source, 0.0)
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{out}.{os.getpid()}.tmp'
        jobs.append((source, src, out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, '-o', tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    failed = []
    for source, src, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc failed on {src}:\n{stdout}\n{stderr}')
            continue
        os.replace(tmp, out)
        build_seconds[source] = time.perf_counter() - t0
    if failed:
        raise RuntimeError('\n'.join(failed))


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if needed (with the rest of
    ``BUILT_TOGETHER`` when it is one of them) and return the loaded
    library."""
    build(BUILT_TOGETHER if source in BUILT_TOGETHER else [source])
    return ctypes.CDLL(_library_path(source)[1])
