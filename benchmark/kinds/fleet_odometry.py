"""Kind ``fleet_odometry``: ``parallel/fleet.fleet_icp_odometry``.

A pool of scans is cast along a route in set-up, decimated at random to
the configuration's points a scan, and given kNN PCA normals here
(:func:`reference.knn_normals`, not the program's).  Every lane turns the
pool by a yaw of its own and starts at an offset of its own; unit k
registers, in every lane, scans k .. k + T - 1 from its offset, each to
the one before, from the true relative motion composed with odometry
noise drawn once a (lane, pool scan).  The numbers compared are the
largest translation and rotation gaps of the chained poses to the
reference's, over every lane and scan of the units checked.
"""

from __future__ import annotations

import math

import torch

from benchmark import generator as gn
from benchmark import reference as rf
from benchmark import sim


class Kind:
    """Inputs and calls of the ``fleet_odometry`` kind."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.device = config, device
        gen = gn.seeded(seed, device)
        L = int(config['lanes'])
        T = int(config['scans_per_step'])
        N = int(config['points_per_scan'])
        P = int(traffic['pool_scans'])
        if T < 2 or P < T:
            raise ValueError('fleet_odometry: needs 2 <= scans_per_step <= '
                             'pool_scans')
        self.L, self.T, self.N, self.P = L, T, N, P
        scene = sim.make_scene(traffic['scene'])
        route = traffic['route']
        ang = (2 * math.pi * torch.arange(P, dtype=torch.float64,
                                          device=device) / P)
        cx, cy = route['center_m']
        r = float(route['radius_m'])
        origin = torch.stack([cx + r * torch.cos(ang), cy + r * torch.sin(ang),
                              torch.full_like(ang, config['sensor_height_m'])],
                             dim=-1)
        rot = sim.yaw_matrix(ang + math.pi / 2)
        pts, hit = sim.cast_scans(
            scene, rot, origin, sim.elevation_table(config['elevation_deg']),
            int(config['azimuths']), gen, config['max_range_m'],
            config['min_range_m'], config['range_noise_m'])
        rows, ok = sim.pick(hit, 1.0, N, gen)
        if not bool(ok.all()):
            raise ValueError('fleet_odometry: a pool scan has fewer hits '
                             f'than {N} points')
        pool = torch.gather(pts, 1, rows[..., None].expand(P, N, 3))
        del pts, hit
        normals = rf.knn_normals(pool, int(config['normal_knn']))
        # True motion from pool scan i to i + 1 (frame i+1 -> frame i).
        nxt = torch.arange(1, P + 1, device=device) % P
        rel_R = rot.transpose(1, 2) @ rot[nxt]
        rel_t = (rot.transpose(1, 2)
                 @ (origin[nxt] - origin)[..., None])[..., 0]
        self.offset = torch.randint(0, P, (L,), generator=gen, device=device)
        yaw = torch.deg2rad((2 * torch.rand(L, generator=gen,
                                            dtype=torch.float64,
                                            device=device) - 1)
                            * float(traffic['lane_yaw_deg']))
        Y = sim.yaw_matrix(yaw)                                   # [L,3,3]
        self.points = torch.einsum('lij,pnj->lpni', Y, pool).float(
            ).contiguous()
        self.normals = torch.einsum('lij,pnj->lpni', Y, normals).float(
            ).contiguous()
        # Each lane's true motion in its turned frames, then the odometry.
        tR = Y[:, None] @ rel_R[None] @ Y[:, None].transpose(-1, -2)
        tt = (Y[:, None] @ rel_t[None, ..., None])[..., 0]
        self.true_R, self.true_t = tR, tt                         # [L,P,...]
        sig = traffic['odom_noise']
        xi = torch.randn((L, P, 6), generator=gen, dtype=torch.float64,
                         device=device)
        xi = xi * torch.tensor([sig['rot_rad']] * 3 + [sig['trans_m']] * 3,
                               dtype=torch.float64, device=device)
        nR, nt = rf.exp_se3(xi)
        oR = tR @ nR
        ot = (tR @ nt[..., None])[..., 0] + tt
        self.odom = rf.rt_to_pose7(oR, ot).float()                # [L,P,7]
        self.masks = torch.ones((L, T, N), dtype=torch.bool, device=device)
        self.init_pose = torch.zeros((L, 7), device=device)
        self.init_pose[:, 0] = 1.0
        self.ident = self.init_pose[:, None, :]
        self.lanes = torch.arange(L, device=device)[:, None]
        self.steps = torch.arange(T, device=device)
        self.scans_per_unit = L * (T - 1)
        self.icp_cfg = None

    def setup_program(self) -> None:
        self.icp_cfg = gn.icp_config(self.config['icp'])

    def drop_program(self) -> None:
        pass

    def _idx(self, k: int) -> torch.Tensor:
        return (self.offset[:, None] + k + self.steps) % self.P    # [L,T]

    def unit(self, k: int):
        idx = self._idx(k)
        odom = torch.cat([self.ident, self.odom[self.lanes, idx[:, :-1]]],
                         dim=1)
        return (self.points[self.lanes, idx], self.masks,
                self.normals[self.lanes, idx], self.init_pose, odom)

    def run(self, inputs) -> torch.Tensor:
        """The program's poses of a unit, on the device: [L,T,7]."""
        from laser_slam_tpu_torch.parallel import fleet
        return fleet.fleet_icp_odometry(*inputs, self.icp_cfg).poses

    @staticmethod
    def compared(poses: torch.Tensor) -> torch.Tensor:
        """The poses that the comparison covers: [L,T-1,7], the first
        pose of a lane being its input."""
        return poses[:, 1:]

    def failed(self, poses: torch.Tensor) -> int:
        return int((~torch.isfinite(self.compared(poses))).any(-1).sum())

    def reference(self, k: int, prec=rf.F64, keep_iterates: bool = False):
        """The reference's chained poses of unit k, (R [L,T-1,3,3], t
        [L,T-1,3]), and the pruned 1-NN calls of its registrations, from
        their iterates, when asked for."""
        pts, masks, nrm, _, odom = self.unit(k)
        R = torch.eye(3, dtype=prec.dtype, device=self.device).expand(
            self.L, 3, 3)
        t = torch.zeros((self.L, 3), dtype=prec.dtype, device=self.device)
        Rs, ts, calls = [], [], []
        for j in range(1, self.T):
            g_R, g_t = rf.pose7_to_rt(odom[:, j], prec.dtype)
            out = rf.icp(pts[:, j], masks[:, j], pts[:, j - 1],
                         nrm[:, j - 1], g_R, g_t, self.config['icp'], prec,
                         keep_iterates)
            t = (R @ out.t[..., None])[..., 0] + t
            R = R @ out.R
            Rs.append(R)
            ts.append(t)
            for iR, it in out.iterates or ():
                q = (pts[:, j].double() @ iR.double().transpose(-1, -2)
                     + it.double()[:, None, :]).float()
                calls.append((q, pts[:, j - 1], True))
        return torch.stack(Rs, 1), torch.stack(ts, 1), calls

    def check(self, outputs: dict, units, walk: bool = False):
        return gn.check_poses(self, outputs, units, walk)

    def control(self, units):
        return gn.control_poses(self, units)

    def truth(self, k: int):
        """The true chained poses of unit k, as :meth:`reference`."""
        idx = self._idx(k)
        R = torch.eye(3, dtype=torch.float64, device=self.device).expand(
            self.L, 3, 3)
        t = torch.zeros((self.L, 3), dtype=torch.float64, device=self.device)
        Rs, ts = [], []
        for j in range(1, self.T):
            sR = self.true_R[self.lanes[:, 0], idx[:, j - 1]]
            st = self.true_t[self.lanes[:, 0], idx[:, j - 1]]
            t = (R @ st[..., None])[..., 0] + t
            R = R @ sR
            Rs.append(R)
            ts.append(t)
        return torch.stack(Rs, 1), torch.stack(ts, 1)
