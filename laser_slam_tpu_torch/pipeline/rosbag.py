"""Minimal, dependency-free rosbag v2.0 reader.

Counterpart of ``laser_slam_tpu/pipeline/rosbag.py`` (pure Python and
numpy, copied), with the port's ``ScanFrame``, packet decoder
(``native.decode_velodyne_packets``) and assembler.  The reference's
native input is a rosbag replayed through roscore
(``laser_slam_worker.cpp:50-51`` subscribes to the assembled PointCloud2
topic; ``velodyne_assembler/launch/test/test.launch:4-21`` replays a
.bag); this module reads the CONTAINER so recorded datasets feed the
port directly, with no ROS install:

* :class:`RosbagReader` iterates decoded messages from a bag file.
  Supported message types: ``sensor_msgs/PointCloud2`` (-> [N,3] float32
  xyz), ``tf2_msgs/TFMessage`` / ``geometry_msgs/TransformStamped``,
  ``nav_msgs/Odometry`` (-> pose7), ``velodyne_msgs/VelodyneScan`` (raw
  1206-byte packets).  Unknown types are surfaced as raw bytes.
* :class:`RosbagStream` pairs each scan with the latest odometry sample
  into replay :class:`ScanFrame` records (the worker's scan callback +
  tf lookup, laser_slam_worker.cpp:99-104).
* :class:`VelodyneBagStream` decodes raw packets and assembles de-skewed
  revolutions.

Format notes (rosbag spec, wiki.ros.org/Bags/Format/2.0): the file is a
sequence of records ``<u32 hlen><header><u32 dlen><data>``; header
fields are ``<u32 flen><name=value>``; chunk records (op=0x05) hold
nested connection/message records, optionally bz2- or lz4-compressed.
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from laser_slam_tpu_torch import native
from laser_slam_tpu_torch.config import AssemblerConfig
from laser_slam_tpu_torch.pipeline.assembler import Packet, RevolutionAssembler
from laser_slam_tpu_torch.pipeline.replay import ScanFrame

# record opcodes
_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONNECTION = 0x07

_U32 = struct.Struct('<I')
_U64 = struct.Struct('<Q')

# sensor_msgs/PointField datatypes
_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def _parse_header(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = _U32.unpack_from(buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        name, _, value = field.partition(b'=')
        fields[name.decode()] = value
    return fields


def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = _U32.unpack_from(buf, off)
    off += 4
    return buf[off:off + n].decode(errors='replace'), off + n


@dataclasses.dataclass
class BagMessage:
    topic: str
    msg_type: str
    time_ns: int          # record (receipt) time
    data: object          # decoded payload (type-dependent) or raw bytes


def _decode_pointcloud2(data: bytes) -> Tuple[int, np.ndarray]:
    """sensor_msgs/PointCloud2 -> (header stamp ns, [N,3] float32 xyz).

    Points whose x is NaN (unreturned rays in organized clouds) are
    dropped.  Layout handled via a strided uint8 view, so any
    point_step / field set works as long as x/y/z exist.
    """
    off = 0
    (_seq,) = _U32.unpack_from(data, off); off += 4
    secs, nsecs = struct.unpack_from('<II', data, off); off += 8
    _frame, off = _read_string(data, off)
    height, width = struct.unpack_from('<II', data, off); off += 8
    (n_fields,) = _U32.unpack_from(data, off); off += 4
    fields = {}
    for _ in range(n_fields):
        name, off = _read_string(data, off)
        foff, dtype, cnt = struct.unpack_from('<IBI', data, off); off += 9
        fields[name] = (foff, dtype, cnt)
    (is_bigendian,) = struct.unpack_from('<B', data, off); off += 1
    point_step, _row_step = struct.unpack_from('<II', data, off); off += 8
    (dlen,) = _U32.unpack_from(data, off); off += 4
    raw = np.frombuffer(data, np.uint8, count=dlen, offset=off)
    if is_bigendian:
        raise ValueError('big-endian PointCloud2 not supported')
    n = (width * height) if point_step == 0 else dlen // point_step
    raw = raw[:n * point_step].reshape(n, point_step)
    cols = []
    for name in ('x', 'y', 'z'):
        if name not in fields:
            raise ValueError(f'PointCloud2 missing field {name!r}')
        foff, dtype, _ = fields[name]
        np_dt = _PF_DTYPES[dtype]
        width_b = np.dtype(np_dt).itemsize
        col = raw[:, foff:foff + width_b].copy().view(np_dt)[:, 0]
        cols.append(col.astype(np.float32))
    xyz = np.stack(cols, axis=1)
    xyz = xyz[np.isfinite(xyz).all(axis=1)]
    return secs * 1_000_000_000 + nsecs, np.ascontiguousarray(xyz)


def _decode_transform(data: bytes, off: int) -> Tuple[int, str, str,
                                                      np.ndarray, int]:
    """geometry_msgs/TransformStamped -> (stamp ns, frame, child, pose7)."""
    (_seq,) = _U32.unpack_from(data, off); off += 4
    secs, nsecs = struct.unpack_from('<II', data, off); off += 8
    frame, off = _read_string(data, off)
    child, off = _read_string(data, off)
    tx, ty, tz, qx, qy, qz, qw = struct.unpack_from('<7d', data, off)
    off += 56
    pose7 = np.array([qw, qx, qy, qz, tx, ty, tz], np.float32)
    return secs * 1_000_000_000 + nsecs, frame, child, pose7, off


def _decode_tf_message(data: bytes):
    (n,) = _U32.unpack_from(data, 0)
    off = 4
    out = []
    for _ in range(n):
        t, frame, child, pose7, off = _decode_transform(data, off)
        out.append((t, frame, child, pose7))
    return out


def _decode_odometry(data: bytes) -> Tuple[int, str, np.ndarray]:
    """nav_msgs/Odometry -> (stamp ns, child_frame, pose7).  Covariance
    and twist are skipped (the worker consumes the pose only)."""
    off = 0
    (_seq,) = _U32.unpack_from(data, off); off += 4
    secs, nsecs = struct.unpack_from('<II', data, off); off += 8
    _frame, off = _read_string(data, off)
    child, off = _read_string(data, off)
    tx, ty, tz = struct.unpack_from('<3d', data, off); off += 24
    qx, qy, qz, qw = struct.unpack_from('<4d', data, off); off += 32
    pose7 = np.array([qw, qx, qy, qz, tx, ty, tz], np.float32)
    return secs * 1_000_000_000 + nsecs, child, pose7


def _decode_velodyne_scan(data: bytes) -> Tuple[int, np.ndarray]:
    """velodyne_msgs/VelodyneScan -> (stamp ns, [P,1206] uint8 packets)."""
    off = 0
    (_seq,) = _U32.unpack_from(data, off); off += 4
    secs, nsecs = struct.unpack_from('<II', data, off); off += 8
    _frame, off = _read_string(data, off)
    (n_pkts,) = _U32.unpack_from(data, off); off += 4
    pkts = np.zeros((n_pkts, 1206), np.uint8)
    for i in range(n_pkts):
        # velodyne_msgs/VelodynePacket: stamp + fixed uint8[1206]
        off += 8                                   # packet stamp
        pkts[i] = np.frombuffer(data, np.uint8, count=1206, offset=off)
        off += 1206
    return secs * 1_000_000_000 + nsecs, pkts


class RosbagReader:
    """Stream decoded messages from a rosbag 2.0 file.

    >>> for m in RosbagReader('log.bag', topics={'/velodyne_points'}):
    ...     stamp_ns, xyz = m.data      # PointCloud2
    """

    def __init__(self, path: str, topics: Optional[set] = None,
                 decode: bool = True):
        self.path = path
        self.topics = topics
        self.decode = decode
        self._connections: Dict[int, Tuple[str, str]] = {}

    # -- record-level iteration ---------------------------------------
    def _records(self, f):
        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (hlen,) = _U32.unpack(head)
            header = _parse_header(f.read(hlen))
            (dlen,) = _U32.unpack(f.read(4))
            data = f.read(dlen)
            yield header, data

    def _nested_records(self, buf: bytes):
        off = 0
        while off < len(buf):
            (hlen,) = _U32.unpack_from(buf, off); off += 4
            header = _parse_header(buf[off:off + hlen]); off += hlen
            (dlen,) = _U32.unpack_from(buf, off); off += 4
            yield header, buf[off:off + dlen]
            off += dlen

    def _handle_connection(self, header, data):
        (conn,) = _U32.unpack(header['conn'])
        info = _parse_header(data)
        self._connections[conn] = (info['topic'].decode(),
                                   info.get('type', b'').decode())

    def _decode_msg(self, msg_type: str, data: bytes):
        if not self.decode:
            return data
        if msg_type.endswith('PointCloud2'):
            return _decode_pointcloud2(data)
        if msg_type.endswith('TFMessage'):
            return _decode_tf_message(data)
        if msg_type.endswith('TransformStamped'):
            t, frame, child, pose7, _ = _decode_transform(data, 0)
            return [(t, frame, child, pose7)]
        if msg_type.endswith('Odometry'):
            return _decode_odometry(data)
        if msg_type.endswith('VelodyneScan'):
            return _decode_velodyne_scan(data)
        return data

    def __iter__(self) -> Iterator[BagMessage]:
        with open(self.path, 'rb') as f:
            magic = f.readline()
            if not magic.startswith(b'#ROSBAG V2.0'):
                raise ValueError(f'{self.path}: not a rosbag 2.0 file '
                                 f'(magic {magic[:16]!r})')
            for header, data in self._records(f):
                op = header.get('op', b'\x00')[0]
                if op == _OP_CONNECTION:
                    self._handle_connection(header, data)
                elif op == _OP_CHUNK:
                    comp = header.get('compression', b'none').decode()
                    if comp == 'bz2':
                        data = bz2.decompress(data)
                    elif comp == 'lz4':
                        try:
                            import lz4.frame
                        except ImportError as e:     # pragma: no cover
                            raise RuntimeError(
                                'bag uses lz4 chunks; lz4 package not '
                                'available in this environment') from e
                        data = lz4.frame.decompress(data)
                    elif comp != 'none':
                        raise ValueError(f'unknown compression {comp!r}')
                    for h2, d2 in self._nested_records(data):
                        op2 = h2.get('op', b'\x00')[0]
                        if op2 == _OP_CONNECTION:
                            self._handle_connection(h2, d2)
                        elif op2 == _OP_MSG:
                            m = self._emit(h2, d2)
                            if m is not None:
                                yield m
                elif op == _OP_MSG:                  # unchunked bag
                    m = self._emit(header, data)
                    if m is not None:
                        yield m
                # bag header / index / chunk-info records are skipped

    def _emit(self, header, data) -> Optional[BagMessage]:
        (conn,) = _U32.unpack(header['conn'])
        topic, msg_type = self._connections.get(conn, ('?', '?'))
        if self.topics is not None and topic not in self.topics:
            return None
        (t,) = _U64.unpack(header['time'])
        secs, nsecs = t & 0xFFFFFFFF, t >> 32
        time_ns = secs * 1_000_000_000 + nsecs
        return BagMessage(topic=topic, msg_type=msg_type, time_ns=time_ns,
                          data=self._decode_msg(msg_type, data))


class RosbagStream:
    """Replay a bag as :class:`replay.ScanFrame` records: each scan on
    ``scan_topic`` is paired with the LATEST odometry sample at-or-before
    its header stamp (the worker's tf lookup, laser_slam_worker.cpp:
    99-104; tf interpolation reduces to latest-sample in practice at
    100 Hz odom vs 10 Hz scans).

    Odometry comes from ``odom_topic`` (nav_msgs/Odometry) or from tf
    (``tf_child_frame`` on /tf).  With neither, frames carry
    ``odom_pose7=None`` (odometry-free mode).
    """

    def __init__(self, path: str, scan_topic: str,
                 odom_topic: Optional[str] = None,
                 tf_child_frame: Optional[str] = None):
        self.path = path
        self.scan_topic = scan_topic
        self.odom_topic = odom_topic
        self.tf_child_frame = tf_child_frame

    def __iter__(self):
        topics = {self.scan_topic}
        if self.odom_topic:
            topics.add(self.odom_topic)
        if self.tf_child_frame:
            topics.update(('/tf', 'tf'))
        last_odom: Optional[np.ndarray] = None
        for m in RosbagReader(self.path, topics=topics):
            if m.topic == self.scan_topic:
                stamp_ns, xyz = m.data
                yield ScanFrame(time_ns=stamp_ns, odom_pose7=last_odom,
                                points=xyz)
            elif self.odom_topic and m.topic == self.odom_topic:
                _, _, pose7 = m.data
                last_odom = pose7
            elif m.topic in ('/tf', 'tf'):
                for _, _, child, pose7 in m.data:
                    if child == self.tf_child_frame:
                        last_odom = pose7


class VelodyneBagStream:
    """Replay a bag of RAW velodyne_msgs/VelodyneScan packets: decode
    each 1206-byte data packet with the native runtime
    (``native.decode_velodyne_packets``) and assemble revolutions with
    motion de-skew (``RevolutionAssembler``): the full
    velodyne_assembler node (velodyne_assembler_ros.cpp:57-143) fed
    straight from the bag, no ROS.

    Yields ``ScanFrame(time_ns, odom_pose7, points)`` per completed
    revolution; ``elev_deg`` selects the sensor's elevation table
    (default VLP-16).
    """

    def __init__(self, path: str, scan_topic: str,
                 odom_topic: Optional[str] = None,
                 tf_child_frame: Optional[str] = None,
                 assembler_config=None, elev_deg=None):
        self.path = path
        self.scan_topic = scan_topic
        self.odom_topic = odom_topic
        self.tf_child_frame = tf_child_frame
        self.assembler_config = assembler_config
        self.elev_deg = elev_deg

    def __iter__(self):
        asm = RevolutionAssembler(self.assembler_config or AssemblerConfig())
        elev = (self.elev_deg if self.elev_deg is not None
                else native.VLP16_ELEV_DEG)
        topics = {self.scan_topic}
        if self.odom_topic:
            topics.add(self.odom_topic)
        if self.tf_child_frame:
            topics.update(('/tf', 'tf'))
        last_odom: Optional[np.ndarray] = None
        for m in RosbagReader(self.path, topics=topics):
            if m.topic == self.scan_topic:
                stamp_ns, pkts = m.data
                for raw in pkts:
                    xyz = native.decode_velodyne_packets(raw.tobytes(),
                                                         elev_deg=elev)
                    done = asm.push(Packet(time_ns=stamp_ns, points=xyz,
                                           odom_base_pose7=last_odom))
                    if done is not None:
                        t, cloud = done
                        yield ScanFrame(time_ns=t, odom_pose7=last_odom,
                                        points=cloud)
            elif self.odom_topic and m.topic == self.odom_topic:
                _, _, pose7 = m.data
                last_odom = pose7
            elif m.topic in ('/tf', 'tf'):
                for _, _, child, pose7 in m.data:
                    if child == self.tf_child_frame:
                        last_odom = pose7
