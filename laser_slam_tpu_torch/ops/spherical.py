"""Sensor-native spherical scan encoding: ship ranges, derive xyz on device.

Counterpart of ``laser_slam_tpu/ops/spherical.py``.  A spinning LiDAR
measures RANGES on a fixed (ring, azimuth) grid; Cartesian xyz is
derived data.  Uploading the sensor's uint16 range words costs 2 B/point
against 12 B for float32 xyz, and the spherical->Cartesian decode runs
as the first stage of the online step
(:func:`pipeline.online.online_step_ranges`).

Conventions match :func:`pipeline.velodyne_sim.beam_directions`
(ring-major layout, azimuth ``2*pi*(j+0.5)/n_azimuth`` from +x, elevation
per ring from the sensor's beam table).  A range word of 0 means "no
echo" (the raw Velodyne convention), so validity rides in-band.

Port notes: torch's ``uint16`` has little op coverage on CUDA, so the
words travel as ``int16`` (a numpy view of the same bytes,
:func:`words_to_device`) and are widened to ``int32`` and masked with
``0xFFFF`` on the device; the decode then reads any integer tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from laser_slam_tpu_torch.ops import cloud as pc

# Native Velodyne range LSB (2 mm) — max encodable range 131.07 m.
RANGE_UNIT_M = 0.002


class BeamTable(NamedTuple):
    """Per-ring / per-column direction tables (device-resident, built once
    per sensor model).  Rings: ``sin_elev/cos_elev [B]``; azimuth
    columns: ``cos_az/sin_az [A]``."""
    sin_elev: torch.Tensor
    cos_elev: torch.Tensor
    cos_az: torch.Tensor
    sin_az: torch.Tensor


def beam_table(elev_deg, n_azimuth: int, device=None) -> BeamTable:
    """The decode table for a beam-model sensor (float64 trigonometry
    rounded once to float32, as the JAX package builds it)."""
    elev = np.deg2rad(np.asarray(elev_deg, np.float64))
    az = 2.0 * np.pi * (np.arange(n_azimuth) + 0.5) / n_azimuth

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    return BeamTable(sin_elev=t(np.sin(elev)), cos_elev=t(np.cos(elev)),
                     cos_az=t(np.cos(az)), sin_az=t(np.sin(az)))


def encode_ranges(ranges_m: np.ndarray, valid: np.ndarray,
                  range_unit_m: float = RANGE_UNIT_M) -> np.ndarray:
    """Host-side encode: metric ranges [B,A] -> uint16 range words
    (0 = no echo).  Valid ranges clip to [1, 65535] units; ranges beyond
    the encodable ceiling become no-echo rather than aliasing to it."""
    words = np.rint(np.asarray(ranges_m, np.float64) / range_unit_m)
    over = words > np.iinfo(np.uint16).max
    words = np.clip(words, 1, np.iinfo(np.uint16).max)
    return np.where(valid & ~over, words, 0).astype(np.uint16)


def words_to_device(ranges_u16: np.ndarray, device) -> torch.Tensor:
    """Upload uint16 range words (any leading shape) as their int16 bytes
    and widen them on the device to int32 words in [0, 65535]."""
    raw = np.ascontiguousarray(ranges_u16, np.uint16).view(np.int16)
    return torch.from_numpy(raw).to(device).to(torch.int32) & 0xFFFF


def decode_range_image(words: torch.Tensor, table: BeamTable,
                       range_unit_m: float = RANGE_UNIT_M) -> pc.Cloud:
    """Integer range words [..., B, A] -> Cloud([..., B*A, 3]).

    Ring-major flattening; zero words are masked and parked at the
    sentinel.  Leading batch dimensions broadcast (the chunked ingest)."""
    unit = torch.tensor(range_unit_m, dtype=torch.float32,
                        device=words.device)
    r = words.to(torch.float32) * unit
    valid = words > 0
    xy = r * table.cos_elev[:, None]                 # horizontal projection
    pts = torch.stack([xy * table.cos_az[None, :],
                       xy * table.sin_az[None, :],
                       r * table.sin_elev[:, None]], dim=-1)
    batch = tuple(words.shape[:-2])
    n = words.shape[-2] * words.shape[-1]
    return pc.park_invalid(pc.Cloud(pts.reshape(batch + (n, 3)),
                                    valid.reshape(batch + (n,))))


def decode_and_pack(words: torch.Tensor, table: BeamTable,
                    range_unit_m: float = RANGE_UNIT_M):
    """Decode then front-pack: ``(points [..., B*A, 3], n_valid [...])``
    int32, valid points first in ring-major order — the layout the xyz
    ingest receives, so both paths share everything downstream."""
    scan = decode_range_image(words, table, range_unit_m)
    packed = pc._pack_scatter(scan, scan.points.shape[-2])
    return packed.points, scan.count().to(torch.int32)
