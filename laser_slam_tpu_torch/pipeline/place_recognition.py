"""Device-resident place-recognition database (scan-context detector).

Counterpart of ``laser_slam_tpu/pipeline/place_recognition.py``: a
fixed-capacity table of polar scan descriptors (ops/scan_context.py)
that answers "have I been here before?" against every stored entry at
once.  It emits the (key_a, key_b, alignment guess) triple the
estimator consumes, in place of the reference's external segmatch node
(incremental_estimator.cpp:63), with the descriptor's yaw seeding the
submap-ICP refinement.

Standalone use:

    det = ScanContextDetector(PlaceRecognitionConfig())
    det.add(points, mask, key=k)                  # stays on the device
    hit = det.query(points, mask, key=k)          # Detection | None

or attach it to an OnlineRunner through ``place_recognition=...``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from laser_slam_tpu_torch.config import PlaceRecognitionConfig
from laser_slam_tpu_torch.ops import scan_context as sc
from laser_slam_tpu_torch.pipeline.online import resolve_device


class Detection(NamedTuple):
    """A place match: database entry ``key`` seen again by the query."""
    key: int             # global pose key of the matched (older) scan
    distance: float      # scan-context distance (0 identical)
    yaw_rad: float       # a_T_b yaw guess: match frame rotated vs query


class ScanContextDetector:
    """Fixed-shape descriptor database; add and query stay on the device.

    Capacity doubles when full.  ``device`` is the card unless the caller
    names another."""

    def __init__(self, config: Optional[PlaceRecognitionConfig] = None,
                 device='cuda'):
        self.config = config or PlaceRecognitionConfig()
        self.device = resolve_device(device)
        c = self.config
        self.db = torch.zeros((c.db_capacity, c.n_rings, c.n_sectors),
                              dtype=torch.float32, device=self.device)
        self.db_keys = torch.full((c.db_capacity,), -1, dtype=torch.int32,
                                  device=self.device)
        self.n = 0

    def ensure_room(self, extra: int = 1) -> None:
        """Grow the table so ``extra`` more adds fit (the chunked online
        path adds a whole chunk of descriptors in one call)."""
        cap = self.db.shape[0]
        new_cap = cap
        while new_cap < self.n + extra:
            new_cap *= 2
        if new_cap == cap:
            return
        pad = new_cap - cap
        self.db = torch.cat([self.db, self.db.new_zeros(
            (pad,) + tuple(self.db.shape[1:]))])
        self.db_keys = torch.cat([self.db_keys,
                                  self.db_keys.new_full((pad,), -1)])

    def _tensor(self, a, dtype) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _store(self, desc: torch.Tensor, key) -> None:
        self.ensure_room(1)
        self.db[self.n] = desc
        self.db_keys[self.n] = key
        self.n += 1

    def add(self, points, mask, key) -> None:
        """Insert one scan (sensor-frame padded points + mask) under its
        global pose key (an int or a 0-d device tensor)."""
        c = self.config
        self._store(sc.descriptor(
            self._tensor(points, torch.float32),
            self._tensor(mask, torch.bool), n_rings=c.n_rings,
            n_sectors=c.n_sectors, max_radius_m=c.max_radius_m,
            z_offset_m=c.z_offset_m), key)

    def query_async(self, points, mask, key: int,
                    add: bool = False) -> Optional[torch.Tensor]:
        """Run a query; return its [3] f32 (matched key, distance, yaw)
        row on the device, unfetched, or None when the database is empty.
        The caller decides when to read it: stack several rows and fetch
        them at once (``PlaceRecognitionConfig.fetch_every``) or pass one
        to :meth:`to_detection`."""
        c = self.config
        desc, dist, shift = sc.descriptor_and_query(
            self.db, self.db_keys, self._tensor(points, torch.float32),
            self._tensor(mask, torch.bool), key - c.exclude_recent_keys,
            n_rings=c.n_rings, n_sectors=c.n_sectors,
            max_radius_m=c.max_radius_m, z_offset_m=c.z_offset_m)
        out = None
        if self.n > 0:
            out = sc.best_row(dist, shift, self.db_keys, c.n_sectors)
        if add:
            self._store(desc, key)
        return out

    def to_detection(self, row) -> Optional[Detection]:
        """Interpret one fetched (host) [3] row against the acceptance
        threshold."""
        k, d, yaw = float(row[0]), float(row[1]), float(row[2])
        if d <= self.config.distance_threshold and k >= 0:
            return Detection(key=int(k), distance=d, yaw_rad=yaw)
        return None

    def query(self, points, mask, key: int,
              add: bool = False) -> Optional[Detection]:
        """Match a scan against every entry older than ``key -
        exclude_recent_keys`` (and insert it with ``add=True``).  Returns
        the best match if it clears ``distance_threshold``, else None.
        Reads the row back at once (:meth:`query_async` defers it)."""
        res = self.query_async(points, mask, key, add=add)
        if res is None:
            return None
        return self.to_detection(res.cpu().numpy())
