"""The control, the plain reference one precision step below the
configuration's (TF32 products for float32 with TF32 off), put in the
program's place, comes out not correct, where the program does not.  At
small sizes on the CPU; the readings the limits were set from are the
cells' own sizes on the card (``benchmark.control``)."""

import pytest
import torch

from benchmark import generator
from benchmark.registry import ROOT, Registry
from benchmark.tests.sizes import small


@pytest.mark.parametrize('workload', ('fleet-odom-outdoor', 'register-b32'))
def test_the_control_fails_a_limit_and_the_program_does_not(workload):
    reg = Registry(ROOT)
    cell = reg.workload(workload)
    over = small(reg, workload)
    cfg = dict(reg.config(cell['config']), **over['config'])
    traffic = dict(reg.traffic(cell['traffic']), **over['traffic'])
    limits = reg.limits(workload)
    gen = generator.make(reg, cfg, traffic, 31, torch.device('cpu'))
    gen.setup_program()
    units = [0, 1]
    outputs = {k: gen.run(gen.unit(k)) for k in units}
    program = gen.check(outputs, units)[0]
    ctl = gen.control(units)
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(ctl[k] > limits[k] for k in limits), ctl
