"""Rosbag v2.0 writer: record scan/odometry/tf streams to a .bag file.

Counterpart of ``laser_slam_tpu/pipeline/bag_writer.py`` (pure Python
and numpy, copied; the packet encoder is the port's one definition in
``velodyne_sim.encode_velodyne_packet``, re-exported here).  With
:mod:`rosbag` (the reader) it closes the loop the reference's ecosystem
relies on: record a sensor run, replay it later (velodyne_assembler's
launch/test/test.launch:4-21 plays a recorded bag).  Implements the
public container format (wiki.ros.org/Bags/Format/2.0) and the message
wire formats the reader decodes: sensor_msgs/PointCloud2,
nav_msgs/Odometry, tf2_msgs/TFMessage, velodyne_msgs/VelodyneScan.

Connection records are duplicated inside chunks, as the spec requires
for self-contained chunk decoding.  A bag written here is byte-equal to
the JAX package's for the same messages, and each package reads the
other's bags.
"""

from __future__ import annotations

import bz2
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from laser_slam_tpu_torch.pipeline.velodyne_sim import (  # noqa: F401
    encode_velodyne_packet)

_U32 = struct.Struct('<I')

MSG_POINTCLOUD2 = 'sensor_msgs/PointCloud2'
MSG_ODOMETRY = 'nav_msgs/Odometry'
MSG_TF = 'tf2_msgs/TFMessage'
MSG_VELODYNE_SCAN = 'velodyne_msgs/VelodyneScan'


def _split_ns(time_ns: int) -> Tuple[int, int]:
    return int(time_ns) // 1_000_000_000, int(time_ns) % 1_000_000_000


def _header(fields: Dict[str, bytes]) -> bytes:
    out = b''
    for k, v in fields.items():
        item = k.encode() + b'=' + v
        out += _U32.pack(len(item)) + item
    return out


def _record(fields: Dict[str, bytes], data: bytes) -> bytes:
    h = _header(fields)
    return _U32.pack(len(h)) + h + _U32.pack(len(data)) + data


def _string(s: str) -> bytes:
    b = s.encode()
    return _U32.pack(len(b)) + b


def _ros_header(seq: int, time_ns: int, frame: str) -> bytes:
    secs, nsecs = _split_ns(time_ns)
    return _U32.pack(seq) + struct.pack('<II', secs, nsecs) + _string(frame)


# ---------------------------------------------------------------------------
# Message payload encoders (inverse of rosbag.py's _decode_* functions)
# ---------------------------------------------------------------------------

def encode_pointcloud2(time_ns: int, xyz: np.ndarray,
                       frame: str = 'velodyne', seq: int = 0) -> bytes:
    """sensor_msgs/PointCloud2 with x/y/z/intensity float32 fields
    (the upstream Velodyne ROS node's layout, which the reader decodes)."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    fields = _U32.pack(4)
    for i, name in enumerate(('x', 'y', 'z', 'intensity')):
        # offset(u32), datatype 7 = FLOAT32, count(u32)
        fields += _string(name) + struct.pack('<IBI', 4 * i, 7, 1)
    pts = np.zeros((n, 4), np.float32)
    pts[:, :3] = xyz
    raw = pts.tobytes()
    return (_ros_header(seq, time_ns, frame)
            + struct.pack('<II', 1, n)            # height, width
            + fields
            + struct.pack('<B', 0)                # is_bigendian
            + struct.pack('<II', 16, 16 * n)      # point_step, row_step
            + _U32.pack(len(raw)) + raw
            + struct.pack('<B', 1))               # is_dense


def encode_odometry(time_ns: int, pose7: np.ndarray, frame: str = 'odom',
                    child: str = 'base_link', seq: int = 0) -> bytes:
    """nav_msgs/Odometry from a pose7 [qw,qx,qy,qz,tx,ty,tz]."""
    qw, qx, qy, qz, tx, ty, tz = [float(v) for v in pose7]
    return (_ros_header(seq, time_ns, frame) + _string(child)
            + struct.pack('<3d', tx, ty, tz)
            + struct.pack('<4d', qx, qy, qz, qw)   # wire order: x,y,z,w
            + struct.pack('<36d', *([0.0] * 36))   # pose covariance
            + struct.pack('<6d', *([0.0] * 6))     # twist
            + struct.pack('<36d', *([0.0] * 36)))  # twist covariance


def encode_tf_message(entries: Sequence[Tuple[int, str, str, np.ndarray]]
                      ) -> bytes:
    """tf2_msgs/TFMessage; entries = [(time_ns, frame, child, pose7)]."""
    out = _U32.pack(len(entries))
    for time_ns, frame, child, pose7 in entries:
        qw, qx, qy, qz, tx, ty, tz = [float(v) for v in pose7]
        out += (_ros_header(0, time_ns, frame) + _string(child)
                + struct.pack('<3d', tx, ty, tz)
                + struct.pack('<4d', qx, qy, qz, qw))
    return out


def encode_velodyne_scan(time_ns: int, packets: Sequence[bytes],
                         frame: str = 'velodyne', seq: int = 0) -> bytes:
    """velodyne_msgs/VelodyneScan: header + VelodynePacket[] (each a
    stamp + 1206 raw bytes)."""
    secs, nsecs = _split_ns(time_ns)
    out = _ros_header(seq, time_ns, frame) + _U32.pack(len(packets))
    for pkt in packets:
        if len(pkt) != 1206:
            raise ValueError(f'velodyne packet must be 1206 bytes, '
                             f'got {len(pkt)}')
        out += struct.pack('<II', secs, nsecs) + bytes(pkt)
    return out


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class BagWriter:
    """Streaming rosbag v2.0 writer.

    Messages buffer into chunks (flushed at ``chunk_bytes`` or on
    close); each chunk carries the connection records of every topic it
    contains, so any chunk decodes standalone.  ``compression`` is
    'none' (default) or 'bz2'.

    Usage::

        with BagWriter(path) as w:
            w.write_odometry('/odom', t_ns, pose7)
            w.write_pointcloud2('/velodyne_points', t_ns, xyz)
    """

    def __init__(self, path: str, compression: str = 'none',
                 chunk_bytes: int = 4 << 20):
        if compression not in ('none', 'bz2'):
            raise ValueError(f'unsupported compression {compression!r}')
        self.compression = compression
        self.chunk_bytes = chunk_bytes
        self._f = open(path, 'wb')
        self._f.write(b'#ROSBAG V2.0\n')
        # Bag-header record (op=3), padded as the spec asks; counts are
        # best-effort (the reader streams records and ignores them).
        self._f.write(_record(
            {'op': b'\x03', 'index_pos': struct.pack('<Q', 0),
             'conn_count': _U32.pack(0), 'chunk_count': _U32.pack(0)},
            b' ' * 128))
        self._conns: Dict[str, Tuple[int, str]] = {}   # topic -> (id, type)
        self._chunk: List[bytes] = []
        self._chunk_conns: Dict[str, bool] = {}
        self._chunk_size = 0
        self._n_msgs = 0

    # -- plumbing ----------------------------------------------------------

    def _conn_record(self, topic: str) -> bytes:
        conn_id, msg_type = self._conns[topic]
        return _record(
            {'op': b'\x07', 'conn': _U32.pack(conn_id),
             'topic': topic.encode()},
            _header({'topic': topic.encode(), 'type': msg_type.encode(),
                     'md5sum': b'0' * 32, 'message_definition': b''}))

    def _write_msg(self, topic: str, msg_type: str, time_ns: int,
                   payload: bytes) -> None:
        if self._f.closed:
            raise ValueError('BagWriter is closed')
        if topic not in self._conns:
            self._conns[topic] = (len(self._conns), msg_type)
        elif self._conns[topic][1] != msg_type:
            raise ValueError(f'topic {topic!r} already bound to '
                             f'{self._conns[topic][1]}')
        if topic not in self._chunk_conns:
            rec = self._conn_record(topic)
            self._chunk.append(rec)
            self._chunk_conns[topic] = True
            self._chunk_size += len(rec)
        secs, nsecs = _split_ns(time_ns)
        rec = _record({'op': b'\x02',
                       'conn': _U32.pack(self._conns[topic][0]),
                       'time': struct.pack('<II', secs, nsecs)}, payload)
        self._chunk.append(rec)
        self._chunk_size += len(rec)
        self._n_msgs += 1
        if self._chunk_size >= self.chunk_bytes:
            self._flush_chunk()

    def _flush_chunk(self) -> None:
        if not self._chunk:
            return
        inner = b''.join(self._chunk)
        data = inner if self.compression == 'none' else bz2.compress(inner)
        self._f.write(_record(
            {'op': b'\x05', 'compression': self.compression.encode(),
             'size': _U32.pack(len(inner))}, data))
        self._chunk = []
        self._chunk_conns = {}
        self._chunk_size = 0

    # -- message API ---------------------------------------------------------

    def write_pointcloud2(self, topic: str, time_ns: int, xyz: np.ndarray,
                          frame: str = 'velodyne') -> None:
        self._write_msg(topic, MSG_POINTCLOUD2, time_ns,
                        encode_pointcloud2(time_ns, xyz, frame,
                                           seq=self._n_msgs))

    def write_odometry(self, topic: str, time_ns: int, pose7: np.ndarray,
                       frame: str = 'odom',
                       child: str = 'base_link') -> None:
        self._write_msg(topic, MSG_ODOMETRY, time_ns,
                        encode_odometry(time_ns, pose7, frame, child,
                                        seq=self._n_msgs))

    def write_tf(self, time_ns: int, frame: str, child: str,
                 pose7: np.ndarray, topic: str = '/tf') -> None:
        self._write_msg(topic, MSG_TF, time_ns,
                        encode_tf_message([(time_ns, frame, child, pose7)]))

    def write_velodyne_scan(self, topic: str, time_ns: int,
                            packets: Sequence[bytes],
                            frame: str = 'velodyne') -> None:
        self._write_msg(topic, MSG_VELODYNE_SCAN, time_ns,
                        encode_velodyne_scan(time_ns, packets, frame,
                                             seq=self._n_msgs))

    def close(self) -> None:
        if not self._f.closed:
            self._flush_chunk()
            self._f.close()

    def __enter__(self) -> 'BagWriter':
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
