"""A short run of each cell on the card, as the benchmark runs it (the
kernels built, the window, the trace and the comparison).  Skips where
there is no card."""

import pytest

from benchmark import run
from benchmark.registry import ROOT, Registry


@pytest.fixture
def card():
    torch = pytest.importorskip('torch')
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('workload', ('fleet-odom-outdoor', 'register-b32'))
@pytest.mark.parametrize('trace', (False, True))
def test_a_short_run_on_the_card_is_correct(card, workload, trace):
    reg = Registry(ROOT)
    result = run.run_cell(reg, workload, 1234567, 2.0, trace, device=card)
    assert result['correct'], result['checks']
    want = reg.per_layer(workload) if trace else reg.end_to_end(workload)
    assert {m['name'] for m in want} == set(result['metrics'])
    assert result['device']['platform'] == 'gpu'
