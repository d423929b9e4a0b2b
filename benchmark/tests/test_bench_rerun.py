"""What ``run.py`` calls of a kind, and in which order (``generator.py``'s
docstring), shown by a toy kind whose program keeps state from unit to
unit, added as files alone and run through ``run_cell`` with
``--trace 1``: the warm-up unit, the window from unit 0, every rerun of
the sample after the window reaching the program's ``run``, and
``check`` given the window's outputs alone."""

import json
import random

import pytest
import torch

from benchmark import run
from benchmark.registry import Registry
from benchmark.tests.test_bench_registry import _copy_benchmark

TOY = '''
import torch

from laser_slam_tpu_torch.core import benchmarker as bench


class Kind:
    """A program that adds each unit's number to a running total and
    returns the total, so that unit k's output depends on every unit run
    before it.  Each call is logged in ``traffic['calls']``."""

    def __init__(self, config, traffic, seed, device):
        self.calls, self.device = traffic['calls'], device
        self.scans_per_unit = 1

    def setup_program(self):
        self.calls.append(('setup',))
        self.total = torch.zeros((), dtype=torch.float64, device=self.device)

    def drop_program(self):
        self.calls.append(('drop',))
        del self.total

    def unit(self, k):
        return torch.tensor(float(k), dtype=torch.float64,
                            device=self.device)

    def run(self, inputs):
        with bench.span('toy.step'):
            self.total = self.total + inputs
        self.calls.append(('run', int(inputs.item())))
        return self.total.clone()

    def failed(self, output):
        return 0

    def check(self, outputs, units, walk=False):
        self.calls.append(('check', sorted(outputs), list(units)))
        # The warm-up adds unit 0, nothing; window unit k: 0 + 1 + ... + k.
        gap = max(abs(float(outputs[k]) - k * (k + 1) / 2) for k in units)
        return {'total_gap': gap}, None
'''


def _toy_benchmark(root):
    _copy_benchmark(root)
    bench = root / 'benchmark'
    (bench / 'kinds' / 'toy_total.py').write_text(TOY)
    (bench / 'configs' / 'toy.json').write_text(
        json.dumps({'name': 'toy', 'kind': 'toy_total'}))
    (bench / 'traffic' / 'toy-units.json').write_text(
        json.dumps({'kind': 'toy_total', 'check_units': 3}))
    (bench / 'limits' / 'toy-total.json').write_text(
        json.dumps({'total_gap': 0.0}))
    spec = json.load(open(root / 'BENCHMARK.json'))
    spec['configs'].append({'name': 'toy', 'source': 'x',
                            'file': 'benchmark/configs/toy.json',
                            'reduced': [], 'why': 'x'})
    spec['workloads'].append({'name': 'toy-total', 'config': 'toy',
                              'traffic': 'toy-units', 'chips': 1,
                              'why': 'x'})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    return Registry(str(root))


@pytest.mark.parametrize('device', ['cpu',
                                    pytest.param('cuda',
                                                 marks=pytest.mark.gpu)])
def test_a_stateful_kind_sees_the_calls_in_the_documented_order(
        tmp_path, device):
    if device == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    reg = _toy_benchmark(tmp_path)
    calls = []
    seed = 2 ** 31 + 17
    result = run.run_cell(reg, 'toy-total', seed, 0.1, True, device=device,
                          overrides={'traffic': {'calls': calls}})
    assert result['correct'], result['checks']
    n = result['attempted']
    sample = sorted(random.Random(seed).sample(range(n), min(3, n)))
    reruns = [('run', k) for k in sample]            # span pass (a)
    if device == 'cuda':
        # The device-only profile, the host's profile of the first unit,
        # span passes (a) and (b).
        reruns = (reruns + [('run', sample[0])] + reruns + reruns)
    assert calls == ([('setup',), ('run', 0)]        # the warm-up
                     + [('run', k) for k in range(n)]
                     + reruns
                     + [('drop',), ('check', list(range(n)), sample)])
    # The reruns moved the total on; the window's outputs were compared.
    assert result['checks']['total_gap']['value'] == 0.0
