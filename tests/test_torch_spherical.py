"""The port's packed-ingest codec and beam simulator against the JAX
package's.

The codec is exact: the same f32 products in the same order, so decoded
points are bit-equal and the range words equal.  The simulator is a
numpy copy, so its frames are bit-equal for the same seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu.ops import spherical as jsp
from laser_slam_tpu.pipeline import velodyne_sim as jvs
from laser_slam_tpu_torch.ops import spherical as tsp
from laser_slam_tpu_torch.pipeline import velodyne_sim as tvs

torch.set_num_threads(2)
A = 128


def beam_words(seed=7, elev=jvs.HDL64_ELEV_DEG, n_azimuth=A):
    scene = jvs.make_beam_scene(seed=1, world_size_m=50.0)
    pose = np.array([1, 0, 0, 0, 3.0, -2.0, 1.5], np.float32)
    return jvs.beam_scan_packed(scene, pose, elev, n_azimuth=n_azimuth,
                                range_noise_m=0.01,
                                rng=np.random.default_rng(seed))


def test_beam_table_matches_jax():
    j = jsp.beam_table(jvs.HDL64_ELEV_DEG, A)
    t = tsp.beam_table(tvs.HDL64_ELEV_DEG, A, device='cpu')
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize('elev', ['hdl64', 'vlp16'])
def test_decode_and_pack_bit_equal(elev):
    table = (jvs.HDL64_ELEV_DEG if elev == 'hdl64'
             else jvs.VLP16_ELEV_DEG_SORTED)
    pts, words = beam_words(elev=table)
    assert words.dtype == np.uint16 and words.shape == (len(table), A)
    jt, tt = jsp.beam_table(table, A), tsp.beam_table(table, A)
    jc = jsp.decode_range_image(jnp.asarray(words), jt)
    tc = tsp.decode_range_image(tsp.words_to_device(words, 'cpu'), tt)
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    jp, jn = jsp.decode_and_pack(jnp.asarray(words), jt)
    tp, tn = tsp.decode_and_pack(tsp.words_to_device(words, 'cpu'), tt)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert int(tn) == int(jn) == len(pts)
    assert tn.dtype == torch.int32


def test_decode_batched_chunk_bit_equal():
    """A [C,B,A] chunk (the chunked ingest) decodes as each scan alone,
    and as the JAX package's batched decode."""
    words = np.stack([beam_words(seed=s)[1] for s in range(3)])
    words[1, :5] = 0                       # a scan with fewer echoes
    jt, tt = jsp.beam_table(jvs.HDL64_ELEV_DEG, A), tsp.beam_table(
        jvs.HDL64_ELEV_DEG, A)
    jp, jn = jsp.decode_and_pack(jnp.asarray(words), jt)
    tp, tn = tsp.decode_and_pack(tsp.words_to_device(words, 'cpu'), tt)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for c in range(3):
        one, n1 = tsp.decode_and_pack(tsp.words_to_device(words[c], 'cpu'),
                                      tt)
        np.testing.assert_array_equal(one.numpy(), tp[c].numpy())
        assert int(n1) == int(tn[c])


def test_words_to_device_keeps_the_high_words():
    words = np.array([[0, 1, 32767, 32768, 65535]], np.uint16)
    got = tsp.words_to_device(words, 'cpu')
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), words.astype(np.int32))


def test_encode_ranges_equal():
    rng = np.random.default_rng(3)
    ranges = np.concatenate([rng.uniform(0.0, 140.0, (4, 256)),
                             np.array([[0.0, 0.0005, 1.0, 131.07, 200.0]
                                       + [5.0] * 251])])
    valid = rng.uniform(size=ranges.shape) > 0.1
    for unit in (tsp.RANGE_UNIT_M, 0.005):
        np.testing.assert_array_equal(
            tsp.encode_ranges(ranges, valid, unit),
            jsp.encode_ranges(ranges, valid, unit))


def test_beam_stream_frames_bit_equal():
    kw = dict(n_scans=3, n_beams=64, n_azimuth=64, trajectory='circle',
              radius_m=12.0, world_size_m=50.0, range_noise_m=0.01,
              odom_noise=0.003, seed=5, packed=True)
    for jf, tf in zip(jvs.BeamStream(**kw), tvs.BeamStream(**kw)):
        assert isinstance(tf, tvs.ScanFrame) and jf.time_ns == tf.time_ns
        for name in ('points', 'range_words', 'odom_pose7', 'gt_pose7'):
            np.testing.assert_array_equal(getattr(tf, name),
                                          getattr(jf, name), err_msg=name)
    kw.update(packed=False, n_beams=16, trajectory='line', laps=2)
    for jf, tf in zip(jvs.BeamStream(**kw), tvs.BeamStream(**kw)):
        np.testing.assert_array_equal(tf.points, jf.points)
        assert tf.range_words is None


def test_scene_makers_and_packets_equal():
    for name, kw in (('make_beam_scene', dict(seed=2)),
                     ('make_corridor_scene', {}),
                     ('make_repeated_rooms_scene', dict(seed=1)),
                     ('make_dynamic_scene', dict(seed=3)),
                     ('make_sloped_clutter_scene', dict(seed=4))):
        j, t = getattr(jvs, name)(**kw), getattr(tvs, name)(**kw)
        np.testing.assert_array_equal(t.boxes, j.boxes)
        assert (t.half_size, t.wall_height, t.ground_slope) == (
            j.half_size, j.wall_height, j.ground_slope)
    scene = tvs.make_beam_scene(seed=2)
    pose = np.array([1, 0, 0, 0, 1.0, 2.0, 1.5], np.float32)
    jp = jvs.velodyne_packets_for_pose(scene, pose, n_blocks=36,
                                       range_noise_m=0.01,
                                       rng=np.random.default_rng(1))
    tp = tvs.velodyne_packets_for_pose(scene, pose, n_blocks=36,
                                       range_noise_m=0.01,
                                       rng=np.random.default_rng(1))
    assert tp == jp and len(tp) == 3 and len(tp[0]) == 1206
