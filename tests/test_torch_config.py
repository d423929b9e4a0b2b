"""The port's config tree against the JAX package's: same fields, same
defaults, and the slice configuration as specified."""

import dataclasses

import pytest
import torch

import laser_slam_tpu.config as jcfg
import laser_slam_tpu_torch.config as tcfg

torch.set_num_threads(2)

CLASSES = ['InputFilterConfig', 'IcpConfig', 'LaserTrackConfig',
           'SolverConfig', 'EstimatorConfig', 'WorkerConfig',
           'BenchmarkerConfig', 'AssemblerConfig', 'PlaceRecognitionConfig',
           'Config']


@pytest.mark.parametrize('name', CLASSES)
def test_same_fields_and_defaults(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(j)]
    tf = [(f.name, str(f.type)) for f in dataclasses.fields(t)]
    assert jf == tf
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())


def test_filter_params_and_chain_canonicalization_match():
    assert jcfg.FILTER_PARAMS == tcfg.FILTER_PARAMS
    chain = [{'type': 'range', 'min_distance_m': 1.0},
             {'type': 'voxel', 'voxel_size_m': 0.2}]
    assert (jcfg._canonical_chain(chain) == tcfg._canonical_chain(chain))
    with pytest.raises(ValueError):
        tcfg._canonical_chain([{'type': 'nope'}])


def test_from_dict_builds_the_same_tree():
    data = {'estimator': {'solver': {'window': 16, 'pcg_iterations': 8},
                          'laser_track': {'icp': {'matcher': 'pallas'}}},
            'n_workers': 2}
    assert (dataclasses.asdict(jcfg._from_dict(jcfg.Config, data))
            == dataclasses.asdict(tcfg._from_dict(tcfg.Config, data)))


def test_slice1_config():
    cfg = tcfg.slice1_config()
    lt = cfg.laser_track
    assert lt.nscan_in_sub_map == 5
    assert (lt.input_filters.scan_capacity,
            lt.input_filters.random_sampling_ratio) == (16384, 1.0)
    icp = lt.icp
    assert (icp.matcher, icp.pallas_prune, icp.normal_method,
            icp.normal_knn, icp.trim_method, icp.reading_sampling_ratio,
            icp.reading_capacity) == ('pallas', True, 'knn', 10, 'sort',
                                      1.0, 8192)
    s = cfg.solver
    assert (s.window, s.method, s.preconditioner, s.matvec,
            s.gn_iterations, s.pcg_iterations, s.pcg_tolerance) == (
        0, 'pcg', 'tridiagonal', 'chain', 3, 128, 1e-10)
    small = tcfg.slice1_config(scan_capacity=1024, reading_capacity=512,
                               nscan_in_sub_map=3)
    assert small.laser_track.input_filters.scan_capacity == 1024
    assert small.laser_track.icp.reading_capacity == 512
    assert small.laser_track.nscan_in_sub_map == 3
