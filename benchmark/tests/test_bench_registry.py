"""The harness finds every part of a cell by name, from files alone, and
``BENCHMARK.json`` keeps to the contract's shapes."""

import json
import os
import re
import shutil

from benchmark import run
from benchmark.registry import ROOT, Registry
from benchmark.tests.sizes import small

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_every_part_of_every_cell_is_found_by_name():
    reg = Registry(ROOT)
    for w in reg.spec['workloads']:
        config = reg.config(w['config'])
        traffic = reg.traffic(w['traffic'])
        assert config['kind'] == traffic['kind']
        assert set(reg.limits(w['name'])) == {'pose_gap_m', 'pose_gap_deg'}
        names = [m['name'] for m in reg.end_to_end(w['name'])]
        assert 'setup_s' in names and len(names) >= 2
        per_layer = reg.per_layer(w['name'])
        assert per_layer
        for m in per_layer:
            assert callable(reg.reader(m['name']))


def test_benchmark_json_keeps_to_the_contract():
    spec = Registry(ROOT).spec
    assert set(spec) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert spec['paths'] == ['benchmark'] and 1 <= spec['run_seconds'] <= 51
    cells = {w['name'] for w in spec['workloads']}
    configs = {c['name'] for c in spec['configs']}
    e2e = {m['name'] for m in spec['end_to_end']}
    for c in spec['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and c['file'].startswith('benchmark/')
        assert all(NAME.match(k) for k in c['reduced'])
        assert json.load(open(os.path.join(ROOT, c['file'])))['name'] == \
            c['name']
    for w in spec['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['config'] in configs and w['chips'] == 1
        assert len(w['why']) <= 200
    for m in spec['end_to_end']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in spec['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['moves'] in e2e and set(m['workloads']) <= cells
        if m['name'].endswith('_roofline'):
            assert m['unit'] == '%'
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) < 65536


def _copy_benchmark(dst):
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), dst)
    shutil.copytree(os.path.join(ROOT, 'benchmark'),
                    os.path.join(dst, 'benchmark'),
                    ignore=shutil.ignore_patterns('__pycache__', '_cache'))


def test_a_new_cell_config_and_metric_are_new_files_and_entries(tmp_path):
    """A cell of the fleet in the repeated-rooms scene, with a
    configuration and a per-layer metric of its own, added as files and
    entries alone, runs through the unchanged harness."""
    _copy_benchmark(tmp_path)
    bench = tmp_path / 'benchmark'
    config = json.load(open(bench / 'configs' / 'fleet256-hdl64-4k.json'))
    config['name'] = 'fleet64-hdl64-4k'
    config['lanes'] = 64
    (bench / 'configs' / 'fleet64-hdl64-4k.json').write_text(
        json.dumps(config))
    traffic = json.load(open(bench / 'traffic' / 'odom-outdoor.json'))
    traffic['scene'] = {'kind': 'repeated_rooms', 'seed': 0}
    traffic['route'] = {'radius_m': 20.0, 'center_m': [45.0, 0.0]}
    (bench / 'traffic' / 'odom-indoor.json').write_text(json.dumps(traffic))
    (bench / 'limits' / 'fleet64-odom-indoor.json').write_text(
        json.dumps({'pose_gap_m': 0.01, 'pose_gap_deg': 0.1}))
    (bench / 'metrics' / 'window_units.py').write_text(
        'def read(ctx):\n    return float(len(ctx.host_issue_ms))\n')
    spec = json.load(open(tmp_path / 'BENCHMARK.json'))
    spec['configs'].append({'name': 'fleet64-hdl64-4k', 'source': 'x',
                            'file': 'benchmark/configs/fleet64-hdl64-4k.json',
                            'reduced': [], 'why': 'x'})
    spec['workloads'].append({'name': 'fleet64-odom-indoor',
                              'config': 'fleet64-hdl64-4k',
                              'traffic': 'odom-indoor', 'chips': 1,
                              'why': 'x'})
    spec['per_layer'].append({'name': 'window_units', 'unit': 'units',
                              'better': 'higher', 'source': 'host_clock',
                              'layer': 'x', 'moves': 'scans_per_s',
                              'workloads': ['fleet64-odom-indoor']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))

    reg = Registry(str(tmp_path))
    assert reg.config('fleet64-hdl64-4k')['lanes'] == 64
    over = small(Registry(ROOT), 'fleet-odom-outdoor')
    result = run.run_cell(reg, 'fleet64-odom-indoor', 5, 0.5, True,
                          device='cpu', overrides=over)
    assert result['correct'], result['checks']
    assert result['metrics']['window_units']['value'] >= 1


def test_a_new_reader_reads_a_span_and_a_counter_by_name(tmp_path):
    """Readers added as files alone, with their entries, read the
    program's spans and counters by name in a traced run: the fleet's
    root span, which no reader of the benchmark reads, and a counter."""
    _copy_benchmark(tmp_path)
    metrics = tmp_path / 'benchmark' / 'metrics'
    (metrics / 'odometry_issue_ms.py').write_text(
        'def read(ctx):\n'
        '    return ctx.spans.get("fleet.icp_odometry", {}).get("issue_ms")\n')
    (metrics / 'gn_steps_per_unit.py').write_text(
        'def read(ctx):\n'
        '    return ctx.counters.get("icp.gn.steps")\n')
    spec = json.load(open(tmp_path / 'BENCHMARK.json'))
    for name, unit, source in (('odometry_issue_ms', 'ms', 'program_span'),
                               ('gn_steps_per_unit', 'steps',
                                'program_counter')):
        spec['per_layer'].append({'name': name, 'unit': unit,
                                  'better': 'lower', 'source': source,
                                  'layer': 'x', 'moves': 'scans_per_s',
                                  'workloads': ['fleet-odom-outdoor']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))

    reg = Registry(str(tmp_path))
    over = small(reg, 'fleet-odom-outdoor')
    result = run.run_cell(reg, 'fleet-odom-outdoor', 2 ** 31 + 3, 0.3, True,
                          device='cpu', overrides=over)
    assert result['correct'], result['checks']
    got = {k: v['value'] for k, v in result['metrics'].items()}
    # The root holds the three stages: its host time is at least theirs.
    assert got['odometry_issue_ms'] >= (got['match_issue_ms']
                                        + got['trim_issue_ms']
                                        + got['gn_issue_ms']) > 0
    assert got['gn_steps_per_unit'] >= 1
    assert result['metrics']['gn_steps_per_unit']['unit'] == 'steps'


def test_a_new_kind_of_traffic_is_a_new_module(tmp_path):
    """A kind of its own (here the fleet's generator under another name),
    with a configuration, a traffic mix and a cell of that kind, added as
    files and entries alone, runs through the unchanged harness."""
    _copy_benchmark(tmp_path)
    bench = tmp_path / 'benchmark'
    shutil.copy(bench / 'kinds' / 'fleet_odometry.py',
                bench / 'kinds' / 'fleet_pairs.py')
    config = json.load(open(bench / 'configs' / 'fleet256-hdl64-4k.json'))
    config.update(name='fleet-pairs', kind='fleet_pairs', scans_per_step=2)
    (bench / 'configs' / 'fleet-pairs.json').write_text(json.dumps(config))
    traffic = json.load(open(bench / 'traffic' / 'odom-outdoor.json'))
    traffic['kind'] = 'fleet_pairs'
    (bench / 'traffic' / 'pairs-outdoor.json').write_text(json.dumps(traffic))
    (bench / 'limits' / 'fleet-pairs-outdoor.json').write_text(
        json.dumps({'pose_gap_m': 0.01, 'pose_gap_deg': 0.1}))
    spec = json.load(open(tmp_path / 'BENCHMARK.json'))
    spec['configs'].append({'name': 'fleet-pairs', 'source': 'x',
                            'file': 'benchmark/configs/fleet-pairs.json',
                            'reduced': [], 'why': 'x'})
    spec['workloads'].append({'name': 'fleet-pairs-outdoor',
                              'config': 'fleet-pairs',
                              'traffic': 'pairs-outdoor', 'chips': 1,
                              'why': 'x'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))

    reg = Registry(str(tmp_path))
    assert reg.kind('fleet_pairs').__file__ == str(
        bench / 'kinds' / 'fleet_pairs.py')
    over = small(Registry(ROOT), 'fleet-odom-outdoor')
    result = run.run_cell(reg, 'fleet-pairs-outdoor', 6, 0.5, False,
                          device='cpu', overrides=over)
    assert result['correct'], result['checks']
    # One registration a lane a unit: 4 lanes at the small size.
    assert result['attempted'] > 0 and result['attempted'] % 4 == 0
