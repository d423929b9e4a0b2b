"""The generator, the simulator and the plain reference at small sizes,
against the simulator's ground truth."""

import math

import numpy as np
import torch

from benchmark import generator, reference as rf, sim
from benchmark.registry import ROOT, Registry
from benchmark.tests.sizes import small

CPU = torch.device('cpu')


def _make(workload, seed, **config):
    reg = Registry(ROOT)
    cell = reg.workload(workload)
    over = small(reg, workload)
    cfg = dict(reg.config(cell['config']), **over['config'])
    cfg.update(config)
    traffic = dict(reg.traffic(cell['traffic']), **over['traffic'])
    return generator.make(reg, cfg, traffic, seed, CPU)


def test_rays_meet_the_ground_and_the_walls_where_geometry_says():
    scene = sim.Scene(half_size=40.0, wall_height=8.0,
                      boxes=np.zeros((0, 2, 3)))
    down = math.radians(-20.0)
    dirs = torch.tensor([[[math.cos(down), 0.0, math.sin(down)],
                          [0.0, 1.0, 0.0]]], dtype=torch.float64)
    origin = torch.tensor([[5.0, 0.0, 1.5]], dtype=torch.float64)
    t = sim.raycast(scene, origin, dirs)[0]
    assert float(t[0]) == __import__('pytest').approx(
        1.5 / math.sin(math.radians(20.0)))
    assert float(t[1]) == __import__('pytest').approx(40.0)


def test_the_route_and_the_map_pose_clear_every_box():
    reg = Registry(ROOT)
    fleet = reg.traffic('odom-outdoor')
    scene = sim.make_scene(fleet['scene'])
    ang = 2 * np.pi * np.arange(fleet['pool_scans']) / fleet['pool_scans']
    r = fleet['route']['radius_m']
    assert sim.clearance(scene, np.stack(
        [r * np.cos(ang), r * np.sin(ang)], 1)).min() > 1.0
    serve = reg.traffic('shared-map-b32')
    x, y = serve['map_pose'][:2]
    # Readings lie within 4 sigma of the map pose.
    margin = 4 * max(serve['offset_sigma_m'][:2]) * math.sqrt(2)
    assert sim.clearance(sim.make_scene(serve['scene']),
                         np.array([[x, y]]))[0] > margin


def test_pick_keeps_hits_only_up_to_the_capacity():
    g = torch.Generator().manual_seed(0)
    hit = torch.rand((3, 1000), generator=g) < 0.8
    rows, mask = sim.pick(hit, 0.5, 300, g)
    assert rows.shape == (3, 300)
    assert bool(torch.all(torch.gather(hit, 1, rows)[mask]))
    assert 0.3 < float(mask.float().mean()) <= 1.0
    assert all(len(set(r.tolist())) == 300 for r in rows)


def test_one_seed_makes_the_same_inputs_and_another_seed_others():
    a = _make('fleet-odom-outdoor', 7).unit(3)
    b = _make('fleet-odom-outdoor', 7).unit(3)
    c = _make('fleet-odom-outdoor', 8).unit(3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_fleet_reference_follows_the_true_motion():
    # Whole scans of 4096 points (the cell's); fewer lanes.
    gen = _make('fleet-odom-outdoor', 11, points_per_scan=4096,
                azimuths=256,
                icp=dict(Registry(ROOT).config('fleet256-hdl64-4k')['icp']))
    R, t, _ = gen.reference(0)
    R_true, t_true = gen.truth(0)
    err = torch.linalg.norm(t - t_true, dim=-1)
    assert float(err.median()) < 0.02
    assert float(rf.rotation_angle_deg(R, R_true).median()) < 0.1
    # The odometry guess lies off the truth; the registration closes in.
    _, _, _, _, odom = gen.unit(0)
    _, g_t = rf.pose7_to_rt(odom[:, 1])
    assert float(err[:, 0].median()) < float(
        torch.linalg.norm(g_t - t_true[:, 0], dim=-1).median())


def test_serving_reference_finds_the_reading_offsets():
    gen = _make('register-b32', 3)
    _, t, _ = gen.reference(0)
    _, t_true = gen.truth(0)
    assert float(torch.linalg.norm(t - t_true, dim=-1).median()) < 0.02


def test_a_pose7_round_trip_and_the_angle_of_a_known_rotation():
    R = sim.yaw_matrix(torch.tensor([0.3], dtype=torch.float64))
    p = rf.rt_to_pose7(R, torch.zeros((1, 3), dtype=torch.float64))
    R2, _ = rf.pose7_to_rt(p)
    assert float((R - R2).abs().max()) < 1e-12
    ident = torch.eye(3, dtype=torch.float64)[None]
    assert float(rf.rotation_angle_deg(ident, R)[0]) == \
        __import__('pytest').approx(math.degrees(0.3))
