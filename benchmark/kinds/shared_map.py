"""Kind ``shared_map``: ``parallel/fleet.batched_icp``.

One revolution at the map pose, decimated at random to the map's points,
is the shared reference; the program derives its normals in set-up, and
the reference works them out again.  A pool of readings is cast at the
map pose plus translations drawn N(0, sigma) (cut at 4 sigma), kept at
random with the sampling probability up to the reading capacity; unit k
registers a batch of them from the identity.  The numbers compared are
the largest translation and rotation gaps of the poses to the
reference's, over every reading of the units checked.
"""

from __future__ import annotations

import math

import torch

from benchmark import generator as gn
from benchmark import reference as rf
from benchmark import sim


class Kind:
    """Inputs and calls of the ``shared_map`` kind."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.device = config, device
        gen = gn.seeded(seed, device)
        B = int(traffic['batch'])
        P = int(traffic['pool_readings'])
        M = int(config['map_points'])
        N = int(config['icp']['reading_capacity'])
        self.B, self.P, self.M, self.N = B, P, M, N
        scene = sim.make_scene(traffic['scene'])
        x, y, z, yaw_deg = traffic['map_pose']
        elev = sim.elevation_table(config['elevation_deg'])
        yaw = torch.full((1,), math.radians(yaw_deg), dtype=torch.float64,
                         device=device)
        Rm = sim.yaw_matrix(yaw)
        om = torch.tensor([[x, y, z]], dtype=torch.float64, device=device)
        kw = dict(max_range_m=config['max_range_m'],
                  min_range_m=config['min_range_m'],
                  range_noise_m=config['range_noise_m'])
        pts, hit = sim.cast_scans(scene, Rm, om, elev,
                                  int(config['map_azimuths']), gen, **kw)
        rows, ok = sim.pick(hit, 1.0, M, gen)
        if not bool(ok.all()):
            raise ValueError(f'shared_map: the map has fewer hits than {M}')
        self.map = torch.gather(pts, 1, rows[..., None].expand(1, M, 3)
                                )[0].float()
        sigma = torch.tensor(traffic['offset_sigma_m'], dtype=torch.float64,
                             device=device)
        off = torch.clamp(torch.randn((P, 3), generator=gen,
                                      dtype=torch.float64, device=device),
                          -4.0, 4.0) * sigma
        pts, hit = sim.cast_scans(scene, Rm.expand(P, 3, 3), om + off, elev,
                                  int(config['reading_azimuths']), gen, **kw)
        rows, mask = sim.pick(hit, float(config['reading_keep_prob']), N, gen)
        rd = torch.gather(pts, 1, rows[..., None].expand(P, N, 3))
        del pts, hit
        self.readings = torch.where(mask[..., None], rd,
                                    torch.full_like(rd, 1.0e6)).float()
        self.masks = mask
        # Reading i in the map's frame: p_map = p_i + Rm^T off_i.
        self.true_t = (Rm.transpose(1, 2) @ off[..., None])[..., 0]
        self.order = torch.randperm(P, generator=gen, device=device)
        self.slots = torch.arange(B, device=device)
        self.guess = torch.zeros((B, 7), device=device)
        self.guess[:, 0] = 1.0
        self.scans_per_unit = B
        self.icp_cfg = self.map_cloud = self.map_normals = None
        self.ref_normals = {}

    def setup_program(self) -> None:
        """The program's set-up: its configuration and the map's normals."""
        from laser_slam_tpu_torch.ops import cloud as pc
        self.icp_cfg = gn.icp_config(self.config['icp'])
        self.map_cloud = pc.Cloud(self.map, torch.ones(
            self.M, dtype=torch.bool, device=self.device))
        self.map_normals = pc.estimate_normals(
            self.map_cloud, int(self.config['normal_knn']))

    def drop_program(self) -> None:
        self.map_cloud = self.map_normals = None

    def _idx(self, k: int) -> torch.Tensor:
        return self.order[(k * self.B + self.slots) % self.P]

    def unit(self, k: int):
        idx = self._idx(k)
        return self.readings[idx], self.masks[idx]

    def run(self, inputs) -> torch.Tensor:
        """The program's poses of a unit, on the device: [B,7]."""
        from laser_slam_tpu_torch.parallel import fleet
        pts, masks = inputs
        return fleet.batched_icp(pts, masks, self.map_cloud,
                                 self.map_normals, self.guess,
                                 self.icp_cfg).T

    @staticmethod
    def compared(poses: torch.Tensor) -> torch.Tensor:
        """The poses that the comparison covers: [B,1,7]."""
        return poses[:, None]

    def failed(self, poses: torch.Tensor) -> int:
        return int((~torch.isfinite(poses)).any(-1).sum())

    def reference(self, k: int, prec=rf.F64, keep_iterates: bool = False):
        """The reference's poses of unit k, (R [B,1,3,3], t [B,1,3]), with
        its own normals of the map, and the pruned 1-NN calls of the
        request, from its iterates, when asked for."""
        if prec not in self.ref_normals:
            self.ref_normals[prec] = rf.knn_normals(
                self.map[None], int(self.config['normal_knn']), prec)
        pts, masks = self.unit(k)
        eye = torch.eye(3, dtype=prec.dtype, device=self.device).expand(
            self.B, 3, 3)
        out = rf.icp(pts, masks, self.map[None], self.ref_normals[prec], eye,
                     torch.zeros((self.B, 3), dtype=prec.dtype,
                                 device=self.device),
                     self.config['icp'], prec, keep_iterates)
        calls = []
        for R, t in out.iterates or ():
            q = (pts.double() @ R.double().transpose(-1, -2)
                 + t.double()[:, None, :]).float()
            calls.append((q.reshape(1, -1, 3), self.map[None], False))
        return out.R[:, None], out.t[:, None], calls

    def check(self, outputs: dict, units, walk: bool = False):
        return gn.check_poses(self, outputs, units, walk)

    def control(self, units):
        return gn.control_poses(self, units)

    def truth(self, k: int):
        eye = torch.eye(3, dtype=torch.float64, device=self.device)
        return (eye.expand(self.B, 1, 3, 3),
                self.true_t[self._idx(k)][:, None])
