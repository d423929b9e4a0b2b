"""Revolution assembler: packets -> full 360-degree de-skewed scans.

Counterpart of ``laser_slam_tpu/pipeline/assembler.py``, the replacement
for ``VelodyneAssemblerRos``
(sensor_drivers/velodyne_assembler/src/velodyne_assembler_ros.cpp): the
reference accumulates per-packet point clouds callback by callback,
segmenting revolutions on the azimuth wrap at +pi/2 (:100-103) and
motion-compensating each packet into the revolution-start frame via the
odometry chain T_sensorStart_sensorCurrent (:115-138); ``naive_assembling``
skips the de-skew (:76-78).  The assembled cloud is stamped at the
revolution END (:110-111) and transformed into the end frame (:107-108).

The per-packet se3 (the chain, the de-skew of a few hundred points)
runs through the port's ``ops/se3`` on float32 CPU tensors, as the JAX
package runs it in float32 ``jnp``: this is host pre-processing between
packets, and on the card each op would only add a launch and a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from laser_slam_tpu_torch.config import AssemblerConfig
from laser_slam_tpu_torch.ops import se3


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _identity() -> np.ndarray:
    return se3.identity().numpy()


@dataclasses.dataclass
class Packet:
    """One sensor packet: points in the CURRENT sensor frame + odometry."""
    time_ns: int
    points: np.ndarray                  # [N,3] sensor frame
    odom_base_pose7: Optional[np.ndarray] = None  # fixed<-base at time_ns


class RevolutionAssembler:
    """Streaming packet assembler with azimuth-wrap segmentation.

    ``T_sensor_base`` is the static sensor<-vehicle extrinsic
    (velodyne_assembler_ros.cpp:34-52); identity by default.
    """

    def __init__(self, config: AssemblerConfig = AssemblerConfig(),
                 T_sensor_base: Optional[np.ndarray] = None):
        self.config = config
        self.T_sensor_base = (np.asarray(T_sensor_base, np.float32)
                              if T_sensor_base is not None else _identity())
        self.T_base_sensor = se3.inverse(_t(self.T_sensor_base)).numpy()
        self._chunks: List[np.ndarray] = []
        self._last_azimuth: Optional[float] = None
        self._last_stamp = 0
        self._T_fixed_base_prev: Optional[np.ndarray] = None
        # sensorStart <- sensorCurrent accumulated over the revolution.
        self._T_start_current = _identity()
        self._initialized = False

    def _relative_sensor_motion(self, odom_base_pose7) -> np.ndarray:
        """T_sensorPrevious_sensorCurrent from base odometry
        (velodyne_assembler_ros.cpp:115-132); identity in naive mode or
        when odometry is missing (:86-91)."""
        if self.config.naive_assembling or odom_base_pose7 is None:
            return _identity()
        T_fb = np.asarray(odom_base_pose7, np.float32)
        if self._T_fixed_base_prev is None:
            rel = _identity()
        else:
            rel_base = se3.compose(se3.inverse(_t(self._T_fixed_base_prev)),
                                   _t(T_fb))
            rel = se3.compose(_t(self.T_sensor_base),
                              se3.compose(rel_base,
                                          _t(self.T_base_sensor))).numpy()
        self._T_fixed_base_prev = T_fb
        return rel

    def push(self, packet: Packet) -> Optional[Tuple[int, np.ndarray]]:
        """Feed one packet; returns (time_ns, points) when a full
        revolution completes, else None.

        The returned cloud is in the END-of-revolution sensor frame,
        stamped with the last packet time (reference :107-111)."""
        pts = np.asarray(packet.points, np.float32)
        if len(pts) == 0:
            return None
        azimuth = float(np.arctan2(pts[0, 1], pts[0, 0]))
        rel = self._relative_sensor_motion(packet.odom_base_pose7)

        out = None
        start = self.config.start_angle_rad
        wrapped = (self._last_azimuth is not None and
                   self._last_azimuth > start and azimuth <= start)
        if wrapped or not self._initialized:
            if self._initialized and self._chunks:
                # Advance the chain with this packet's motion, then move the
                # assembled cloud into the end frame (reference :107-119).
                self._T_start_current = se3.compose(
                    _t(self._T_start_current), _t(rel)).numpy()
                assembled = np.concatenate(self._chunks)
                T_end_start = se3.inverse(_t(self._T_start_current))
                assembled = se3.apply(T_end_start, _t(assembled)).numpy()
                out = (self._last_stamp, assembled)
            self._chunks = [pts]
            self._T_start_current = _identity()
            self._initialized = True
        else:
            self._T_start_current = se3.compose(
                _t(self._T_start_current), _t(rel)).numpy()
            # De-skew: packet points into the revolution-start frame
            # (reference :135-138).
            moved = se3.apply(_t(self._T_start_current), _t(pts)).numpy()
            self._chunks.append(moved)

        self._last_azimuth = azimuth
        self._last_stamp = packet.time_ns
        return out


def assemble_stream(packets: Sequence[Packet],
                    config: AssemblerConfig = AssemblerConfig(),
                    T_sensor_base: Optional[np.ndarray] = None
                    ) -> Iterator[Tuple[int, np.ndarray]]:
    """Assemble a packet sequence into revolution scans."""
    asm = RevolutionAssembler(config, T_sensor_base)
    for p in packets:
        out = asm.push(p)
        if out is not None:
            yield out


def split_scan_into_packets(points: np.ndarray, time_ns: int,
                            n_packets: int = 36) -> List[np.ndarray]:
    """Test/replay helper: slice a full revolution into azimuth-ordered
    packets starting just below +pi/2 and sweeping clockwise, matching the
    reference's wrap convention."""
    az = np.arctan2(points[:, 1], points[:, 0])
    # Order points by decreasing azimuth starting at +pi/2.
    shifted = np.mod(np.pi / 2 - az, 2 * np.pi)
    order = np.argsort(shifted)
    chunks = np.array_split(points[order], n_packets)
    return [c for c in chunks if len(c)]
