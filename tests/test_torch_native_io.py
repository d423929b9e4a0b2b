"""The port's native IO runtime (``laser_slam_tpu_torch/native``) against
the JAX package's ``laser_slam_tpu/native``.

The port builds its own copy of io.cpp under ``laser_slam_tpu_torch/
_build/`` with g++.  Tolerances: KITTI decoding byte-equal to JAX's
through the library and through numpy; the packet decoder's library and
numpy versions bit-equal to each other, and each within 2 float32 units
in the last place of JAX's (JAX's own library and numpy versions round
their float32 sines and cosines differently, by up to 2 units; the
port's two round float64 values once, so they agree); voxel downsampling
the same set of cells as JAX's; the prefetch loader the same scans in
order, run to the end and stopped early.
"""

import os

import numpy as np
import pytest

from laser_slam_tpu import native as jnative
from laser_slam_tpu_torch import native
from laser_slam_tpu_torch.pipeline import velodyne_sim as vs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Twice the largest gap to JAX's decoder measured on these packets, in
# float32 units in the last place.
DECODE_ULPS = 2


def write_bin(path, n, rng):
    pts = (rng.normal(size=(n, 4)) * 10).astype(np.float32)
    pts.tofile(path)
    return pts[:, :3]


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    same_sign = np.sign(a) == np.sign(b)
    assert np.all(same_sign | (np.abs(a - b) < 1e-30))
    return int(np.abs(ia - ib).max()) if a.size else 0


def packets(kind, rng):
    """Raw packet bytes: a VLP-16 revolution of the simulator, the same as
    dual-return packets, with malformed blocks, or a stream gap."""
    scene = vs.make_beam_scene(seed=3, world_size_m=60.0)
    pose = np.array([np.cos(0.3), 0, 0, np.sin(0.3), 6.0, 4.0, 1.5])
    pkts = [p for k in range(15) for p in vs.velodyne_packets_for_pose(
        scene, pose, n_blocks=12, blocks_per_rev=180, az_start_deg=24.0 * k,
        range_noise_m=0.01, rng=rng)]
    if kind == 'dual':
        pkts = [p[:1204] + bytes([0x39]) + p[1205:] for p in pkts]
    elif kind == 'malformed':
        pkts = [bytearray(p) for p in pkts]
        for p in pkts[::3]:
            p[500:502] = b'\x00\x00'       # block 5's flag
        pkts = [bytes(p) for p in pkts]
    elif kind == 'gap':
        pkts = pkts[:4] + pkts[9:]         # a 60 degree jump
    return b''.join(pkts)


def test_library_builds_inside_the_port():
    path = native.loaded_path()
    assert path is not None, native.build_error
    build = os.path.join(REPO, 'laser_slam_tpu_torch', '_build')
    assert os.path.dirname(path) == build
    assert os.path.basename(path).startswith('liblaserslamio_')
    jax_pkg = os.path.join(REPO, 'laser_slam_tpu') + os.sep
    assert not path.startswith(jax_pkg)
    assert native.library_path() == path


def test_no_compiler_means_numpy_and_require_raises(tmp_path, monkeypatch,
                                                    rng):
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_lib_path', None)
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(native, 'library_path',
                        lambda: str(tmp_path / 'liblaserslamio_x.so'))
    monkeypatch.setenv('CXX', 'no-such-compiler-here')
    assert native.loaded_path() is None
    assert 'no C++ compiler' in native.build_error
    with pytest.raises(RuntimeError, match='unavailable'):
        native.require_native()
    path = str(tmp_path / 'a.bin')
    want = write_bin(path, 100, rng)
    assert native.decode_kitti_bin(path).tobytes() == want.tobytes()
    assert not native.PrefetchLoader([path]).native


@pytest.mark.parametrize('max_points', [200_000, 700])
def test_decode_kitti_bin_matches_jax(tmp_path, rng, monkeypatch,
                                      max_points):
    path = str(tmp_path / '000000.bin')
    xyz = write_bin(path, 1000, rng)
    got = native.decode_kitti_bin(path, max_points)
    assert got.tobytes() == xyz[:max_points].tobytes()
    assert got.tobytes() == jnative.decode_kitti_bin(path, max_points) \
        .tobytes()
    assert native.decode_kitti_bin_plain(path, max_points).tobytes() == \
        got.tobytes()
    with pytest.raises(FileNotFoundError):
        native.decode_kitti_bin(str(tmp_path / 'missing.bin'))
    monkeypatch.setattr(jnative, '_try_load', lambda: None)
    monkeypatch.setattr(native, '_try_load', lambda: None)
    assert native.decode_kitti_bin(path, max_points).tobytes() == \
        jnative.decode_kitti_bin(path, max_points).tobytes()


@pytest.mark.parametrize('kind', ['single', 'dual', 'malformed', 'gap'])
def test_decode_velodyne_packets_matches_jax(rng, monkeypatch, kind):
    raw = packets(kind, rng)
    ours = native.decode_velodyne_packets(raw)
    plain = native.decode_velodyne_packets_plain(raw)
    assert len(ours) > 1000
    assert ours.tobytes() == plain.tobytes()
    theirs = jnative.decode_velodyne_packets(raw)
    gap_lib = ulps(ours, theirs)
    monkeypatch.setattr(jnative, '_try_load', lambda: None)
    monkeypatch.setattr(native, '_try_load', lambda: None)
    theirs_np = jnative.decode_velodyne_packets(raw)
    gap_np = ulps(native.decode_velodyne_packets(raw), theirs_np)
    split = int(np.sum(theirs.view(np.uint32) != theirs_np.view(np.uint32)))
    print(f'{kind}: library {gap_lib} ulp, numpy {gap_np} ulp from JAX; '
          f'JAX\'s library and numpy differ in {split} of {theirs.size} '
          f'coordinates (max {np.abs(theirs - theirs_np).max():.2e} m)')
    assert gap_lib <= DECODE_ULPS and gap_np <= DECODE_ULPS
    # max_points cuts in decode order on both paths.
    cut = native.decode_velodyne_packets(raw, max_points=333)
    monkeypatch.undo()
    assert native.decode_velodyne_packets(raw, max_points=333).tobytes() \
        == cut.tobytes() == ours[:333].tobytes()


def test_decode_velodyne_packets_elevation_table(rng):
    raw = packets('single', rng)
    hdl32 = tuple(np.linspace(-30.67, 10.67, 32))
    ours = native.decode_velodyne_packets(raw, elev_deg=hdl32)
    assert ours.tobytes() == native.decode_velodyne_packets_plain(
        raw, elev_deg=hdl32).tobytes()
    assert ulps(ours, jnative.decode_velodyne_packets(
        raw, elev_deg=hdl32)) <= DECODE_ULPS
    assert native.decode_velodyne_packets(b'').shape == (0, 3)


def test_voxel_downsample_same_cells_as_jax(rng, monkeypatch):
    base = rng.uniform(-10, 10, size=(300, 3)).astype(np.float32)
    pts = (np.repeat(base, 5, axis=0)
           + rng.normal(size=(1500, 3)).astype(np.float32) * 0.05)
    for cell in (0.5, 2.0):
        ours = native.voxel_downsample(pts, cell)
        plain = native.voxel_downsample_plain(pts, cell)
        theirs = jnative.voxel_downsample(pts, cell)
        assert ours.tobytes() == theirs.tobytes() == plain.tobytes()
        cells = {tuple(c) for c in np.floor(ours / cell).astype(np.int64)}
        assert len(cells) == len(ours)
        assert cells == {tuple(c) for c in np.floor(pts / cell)
                         .astype(np.int64)}
        monkeypatch.setattr(jnative, '_try_load', lambda: None)
        assert jnative.voxel_downsample(pts, cell).tobytes() == \
            plain.tobytes()
        monkeypatch.undo()


@pytest.fixture
def scan_files(tmp_path, rng):
    paths, want = [], []
    for i in range(7):
        p = str(tmp_path / f'{i:06d}.bin')
        want.append(write_bin(p, 300 + 50 * i, rng))
        paths.append(p)
    return paths, want


@pytest.mark.parametrize('voxel_cell', [0.0, 2.0])
@pytest.mark.parametrize('path', ['native', 'numpy'])
def test_prefetch_loader_runs_to_the_end(scan_files, monkeypatch,
                                         voxel_cell, path):
    paths, want = scan_files
    if path == 'numpy':
        monkeypatch.setattr(native, '_try_load', lambda: None)
    with native.PrefetchLoader(paths, max_points=1000, voxel_cell=voxel_cell,
                               depth=2) as loader:
        assert loader.native == (path == 'native')
        got = list(loader)
        if loader.native:
            assert list(loader) == []      # the thread serves one pass
    assert [i for i, _ in got] == list(range(len(paths)))
    jloader = jnative.PrefetchLoader(paths, max_points=1000,
                                     voxel_cell=voxel_cell)
    for (_, pts), (_, jpts), w in zip(got, jloader, want):
        assert pts.tobytes() == jpts.tobytes()
        if voxel_cell:
            assert pts.tobytes() == native.voxel_downsample_plain(
                w, voxel_cell).tobytes()
        else:
            assert pts.tobytes() == w.tobytes()
    jloader.close()


def test_prefetch_loader_closes_early(scan_files):
    paths, want = scan_files
    loader = native.PrefetchLoader(paths * 20, max_points=1000, depth=2)
    it = iter(loader)
    first = [next(it) for _ in range(3)]
    assert [i for i, _ in first] == [0, 1, 2]
    assert first[2][1].tobytes() == want[2].tobytes()
    loader.close()                 # the producer is blocked on a full ring
    assert list(it) == []
    loader.close()
    with native.PrefetchLoader(paths, max_points=1000) as loader:
        pass                       # never iterated: still joins
    del loader
