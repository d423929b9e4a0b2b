"""ctypes bindings for the native IO runtime (``native/io.cpp``).

Counterpart of the JAX package's ``native`` module: KITTI ``.bin``
decoding, a host voxel downsample, a background-thread prefetch loader
and the raw Velodyne packet decoder.  The port keeps its own copy of
``io.cpp``; at first use it is compiled with g++ into
``laser_slam_tpu_torch/_build/`` (git-ignored) under a name that hashes
the source and the flags, so an edited source builds anew and an
unchanged one is reused.  Nothing is built at import.

The numpy versions (``*_plain``) are the plain versions and the test
oracle; a call takes them only where the library cannot be built (no
compiler).  :func:`loaded_path` says which path is active and
:func:`require_native` raises with the compiler's output instead of
falling back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, 'io.cpp')
BUILD_DIR = os.path.join(os.path.dirname(_DIR), '_build')
# JAX's Makefile flags less -march=native: a library built on one host
# stays loadable on another (no vector instruction changes a result here).
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-Wall', '-shared')

_lib = None
_lib_path: Optional[str] = None
build_error: Optional[str] = None     # why the last build failed, if it did

# Default VLP-16 elevation angles (degrees), firing order: the public
# interleaved -15..+15 pattern from the VLP-16 manual.
VLP16_ELEV_DEG = (-15.0, 1.0, -13.0, 3.0, -11.0, 5.0, -9.0, 7.0,
                  -7.0, 9.0, -5.0, 11.0, -3.0, 13.0, -1.0, 15.0)


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    with open(SOURCE, 'rb') as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f'liblaserslamio_{digest.hexdigest()[:16]}.so')


def _build(out: str) -> None:
    cxx = shutil.which(os.environ.get('CXX', 'g++'))
    if cxx is None:
        raise RuntimeError('no C++ compiler (g++ or $CXX) on PATH')
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.run([cxx, *CXX_FLAGS, '-o', tmp, SOURCE, '-lpthread'],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed on {SOURCE}:\n{proc.stdout}\n'
                           f'{proc.stderr}')
    os.replace(tmp, out)       # atomic: concurrent builds agree


def _try_load():
    """The loaded library, building it first if needed; None when it
    cannot be built or loaded (``build_error`` says why)."""
    global _lib, _lib_path, build_error
    if _lib is not None:
        return _lib
    out = library_path()
    try:
        if not os.path.exists(out):
            _build(out)
        lib = ctypes.CDLL(out)
        _bind(lib)
    except (OSError, AttributeError, RuntimeError,
            subprocess.SubprocessError) as e:
        build_error = str(e)
        return None
    _lib, _lib_path, build_error = lib, out, None
    return lib


def loaded_path() -> Optional[str]:
    """The loaded library's path (building it first if needed), None
    while the numpy path is active."""
    return _lib_path if _try_load() is not None else None


def require_native():
    """The loaded library; raises with the build's error instead of
    letting a caller fall back to numpy."""
    lib = _try_load()
    if lib is None:
        raise RuntimeError(f'native IO library unavailable: {build_error}')
    return lib


def _bind(lib) -> None:
    lib.decode_kitti_bin.restype = ctypes.c_long
    lib.decode_kitti_bin.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_long]
    lib.voxel_downsample.restype = ctypes.c_long
    lib.voxel_downsample.argtypes = [ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_long, ctypes.c_float,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_long]
    lib.loader_open.restype = ctypes.c_void_p
    lib.loader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                ctypes.c_long, ctypes.c_long,
                                ctypes.c_float, ctypes.c_long]
    lib.loader_next.restype = ctypes.c_long
    lib.loader_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_long,
                                ctypes.POINTER(ctypes.c_long)]
    lib.loader_close.restype = None
    lib.loader_close.argtypes = [ctypes.c_void_p]
    lib.decode_velodyne_packets.restype = ctypes.c_long
    lib.decode_velodyne_packets.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------------------
# KITTI scans
# ---------------------------------------------------------------------------

def decode_kitti_bin_plain(path: str, max_points: int = 200_000
                           ) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return raw[:max_points, :3].copy()


def decode_kitti_bin(path: str, max_points: int = 200_000) -> np.ndarray:
    """Decode a KITTI velodyne .bin to [N,3] xyz float32."""
    lib = _try_load()
    if lib is None:
        return decode_kitti_bin_plain(path, max_points)
    out = np.empty((max_points, 3), np.float32)
    n = lib.decode_kitti_bin(path.encode(), _f32p(out), max_points)
    if n < 0:
        raise FileNotFoundError(path)
    return out[:n]


def voxel_downsample_plain(points: np.ndarray, cell: float) -> np.ndarray:
    points = np.ascontiguousarray(points, np.float32)
    cells = np.floor(points / cell).astype(np.int64)
    _, idx = np.unique(cells, axis=0, return_index=True)
    return points[np.sort(idx)]


def voxel_downsample(points: np.ndarray, cell: float) -> np.ndarray:
    """Host-side first-point-per-voxel downsample."""
    points = np.ascontiguousarray(points, np.float32)
    lib = _try_load()
    if lib is None:
        return voxel_downsample_plain(points, cell)
    out = np.empty_like(points)
    m = lib.voxel_downsample(_f32p(points), len(points), cell, _f32p(out),
                             len(points))
    return out[:m]


class PrefetchLoader:
    """Background-thread scan loader: decode (+ optional host voxel
    pre-filter) of a file list into a ring buffer of ``depth`` slots.

    Iterates (index, points[N,3]) in order.  The native thread serves
    one pass and copies a slot into the Python buffer under the ring's
    lock, so the caller never reads a slot the thread is writing.  Close
    the loader (or use it as a context manager) to stop the thread
    early; closing twice is harmless.  Without the library it decodes
    synchronously, again on each pass.
    """

    def __init__(self, paths: Sequence[str], max_points: int = 200_000,
                 voxel_cell: float = 0.0, depth: int = 4):
        self._paths = list(paths)
        self._max_points = max_points
        self._voxel_cell = voxel_cell
        self._lib = _try_load()
        self._handle = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self._paths))(
                *[p.encode() for p in self._paths])
            self._handle = self._lib.loader_open(
                arr, len(self._paths), max_points,
                ctypes.c_float(voxel_cell), depth)

    @property
    def native(self) -> bool:
        """Whether the native thread serves this loader."""
        return self._lib is not None

    def __iter__(self):
        if self._lib is None:
            for i, p in enumerate(self._paths):
                pts = decode_kitti_bin(p, self._max_points)
                if self._voxel_cell > 0:
                    pts = voxel_downsample(pts, self._voxel_cell)
                yield i, pts
            return
        buf = np.empty((self._max_points, 3), np.float32)
        idx = ctypes.c_long()
        while self._handle is not None:
            n = self._lib.loader_next(self._handle, _f32p(buf),
                                      self._max_points, ctypes.byref(idx))
            if idx.value < 0:
                break
            yield int(idx.value), buf[:n].copy()

    def close(self):
        if self._handle is not None:
            self._lib.loader_close(self._handle)
            self._handle = None

    def __enter__(self) -> 'PrefetchLoader':
        return self

    def __exit__(self, *exc):
        self.close()
        return None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Raw Velodyne packets
# ---------------------------------------------------------------------------

def _trig(x: np.ndarray, fn) -> np.ndarray:
    """``fn`` of float32 ``x`` in float64, rounded once to float32, as
    io.cpp computes it."""
    return fn(x.astype(np.float64)).astype(np.float32)


def decode_velodyne_packets_plain(raw: bytes,
                                  elev_deg: Sequence[float] = VLP16_ELEV_DEG,
                                  max_points: int = 200_000) -> np.ndarray:
    """numpy version of :func:`decode_velodyne_packets` (same semantics,
    bit-equal results)."""
    n_packets = len(raw) // 1206
    if n_packets == 0:
        return np.zeros((0, 3), np.float32)
    elev = np.deg2rad(np.asarray(elev_deg, np.float32))
    data = np.frombuffer(raw, dtype=np.uint8,
                         count=n_packets * 1206).reshape(n_packets, 1206)
    mode = data[:, 1204]
    dual = np.isin(mode, (0x39, 0x3A, 0x3B))
    blocks = data[:, :1200].reshape(n_packets, 12, 100)
    # Dual-return: keep only even blocks of each (last, strongest) pair.
    block_keep = np.ones((n_packets, 12), bool)
    block_keep[dual, 1::2] = False
    blocks = blocks[block_keep]              # [B,100] decode-ordered
    flag = blocks[:, 0].astype(np.uint16) | (
        blocks[:, 1].astype(np.uint16) << 8)
    az = (blocks[:, 2].astype(np.uint32) |
          (blocks[:, 3].astype(np.uint32) << 8)).astype(np.float32) * 0.01
    # Per-block azimuth gap to the next decoded block (wrap into [0,360);
    # gaps across stream discontinuities (> 10 deg) and the final block
    # reuse the previous block's gap, as in the native decoder).
    gap = np.zeros_like(az)
    if len(az) > 1:
        gap[:-1] = np.mod(az[1:] - az[:-1], 360.0)
        bad = gap > 10.0
        bad[-1] = True
        prev = 0.0
        for i in range(len(gap)):
            if bad[i]:
                gap[i] = prev
            else:
                prev = gap[i]
    rec = blocks[:, 4:100].reshape(-1, 32, 3)
    dist = (rec[..., 0].astype(np.uint32) |
            (rec[..., 1].astype(np.uint32) << 8)).astype(np.float32) * 0.002
    ch_frac = (np.arange(32, dtype=np.float32) / 32.0)[None, :]
    az_rad = np.deg2rad(az[:, None] + gap[:, None] * ch_frac)
    d = elev[np.arange(32) % len(elev)][None, :]
    r = dist
    cos_d = _trig(d, np.cos)
    x = r * cos_d * _trig(az_rad, np.sin)
    y = r * cos_d * _trig(az_rad, np.cos)
    z = r * _trig(d, np.sin)
    keep = (dist > 0) & (flag == 0xEEFF)[:, None]
    pts = np.stack([x[keep], y[keep], z[keep]], axis=1).astype(np.float32)
    return pts[:max_points]


def decode_velodyne_packets(raw: bytes,
                            elev_deg: Sequence[float] = VLP16_ELEV_DEG,
                            max_points: int = 200_000) -> np.ndarray:
    """Decode raw 1206-byte Velodyne data packets to [N,3] xyz float32.

    Packet layout: 12 blocks of (0xEEFF flag, uint16 azimuth in 0.01
    deg, 32 x (uint16 distance in 2 mm, uint8 intensity)); zero-distance
    returns are dropped.  Azimuth is interpolated per channel across the
    block (channel c adds ``gap * c/32`` of the azimuth step to the next
    decoded block); dual-return packets (factory byte 0x39/0x3A/0x3B at
    offset 1204) decode only the even block of each (last, strongest)
    pair.  Feed the result per packet into
    ``pipeline.assembler.RevolutionAssembler``.
    """
    n_packets = len(raw) // 1206
    if n_packets == 0:
        return np.zeros((0, 3), np.float32)
    lib = _try_load()
    if lib is None:
        return decode_velodyne_packets_plain(raw, elev_deg, max_points)
    elev = np.deg2rad(np.asarray(elev_deg, np.float32))
    data = np.frombuffer(raw, dtype=np.uint8, count=n_packets * 1206)
    out = np.empty((max_points, 3), np.float32)
    n = lib.decode_velodyne_packets(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_packets,
        _f32p(elev), len(elev), _f32p(out), max_points)
    return out[:n].copy()
