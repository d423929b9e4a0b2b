"""The readings that a cell's limits are set from, at the cell's own size.

    python3 -m benchmark.control --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 [--units 4]

For each seed: the cell's inputs and the program's set-up as a run makes
them, ``--units`` units of the program in a closed loop, and the numbers
a run compares (the kind's ``check``) for the units a run would sample
from them.  Those are the lower readings.  For each control seed the control
stands in the program's place: the plain reference computed one step
below the configuration's precision (``reference.TF32``), compared with
the reference in float64 as the program is.  Those are the upper
readings.  One JSON line a seed, then a summary line.

Runs on the card; a run of the benchmark does not call it.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

from benchmark import generator
from benchmark.registry import ROOT, Registry


def readings(reg: Registry, workload: str, seed: int, units: int,
             control: bool, device='cuda') -> dict:
    import torch
    cell = reg.workload(workload)
    config = reg.config(cell['config'])
    traffic = reg.traffic(cell['traffic'])
    gen = generator.make(reg, config, traffic, seed, torch.device(device))
    gen.setup_program()
    outputs = {}
    for k in range(units):
        outputs[k] = gen.run(gen.unit(k)).cpu()
    gen.drop_program()
    sample = sorted(random.Random(seed).sample(
        range(units), min(int(traffic['check_units']), units)))
    out = {'seed': seed, 'units': sample,
           'program': gen.check(outputs, sample)[0]}
    if control:
        out['control'] = gen.control(sample)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--units', type=int, default=4)
    args = ap.parse_args(argv)
    reg = Registry(ROOT)
    seeds = [int(s) for s in args.seeds.split(',') if s]
    ctl = {int(s) for s in args.control_seeds.split(',') if s}
    lower, upper = {}, {}
    for seed in sorted(set(seeds) | ctl):
        t0 = time.perf_counter()
        r = readings(reg, args.workload, seed, args.units, seed in ctl)
        r['seconds'] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        for name, v in r['program'].items():
            lower[name] = max(lower.get(name, 0.0), v)
        for name, v in r.get('control', {}).items():
            upper[name] = min(upper.get(name, float('inf')), v)
    print(json.dumps({'workload': args.workload, 'lower': lower,
                      'upper': upper}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
