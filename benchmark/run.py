"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
and a traffic mix; the mix's kind (``kinds/<kind>.py``, found by name)
makes the inputs from the seed on the card and drives the program,
``laser_slam_tpu_torch``.

A run: set-up (imports, the card, the kernels' library from the
checkout's build cache, the inputs, the program's set-up, one warm-up
unit), then a closed loop of units of work for ``--seconds``: one client
submits the next unit when the previous one's poses are on the host.
Once the window has closed and the memory peak is read, a sample of the
window's units is drawn from the seed; with ``--trace 1`` those units are
run again under the profiler, then twice more with the program's spans
and counters kept (``stages.span_passes``; on the CPU once).  Then the
plain reference (``reference.py``) works the sample out again, in one
pass that also counts the pruned 1-NN calls of the traced units for
their bound, and the numbers of the cell's kind are compared with
``limits/<workload>.json``.

The last line of standard output is the result, a JSON object; the last
lines of standard error give each compared number beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

from benchmark.registry import ROOT, Registry  # noqa: E402

PROGRAM = 'laser_slam_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'laser_slam_tpu')


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_env(root: str) -> None:
    """Every kernel cache a run may fill, at fixed paths in the checkout
    (the program builds its own CUDA library under ``laser_slam_tpu_torch/
    _build/``)."""
    base = os.path.join(root, 'benchmark', '_cache')
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('PYTORCH_KERNEL_CACHE_PATH', 'torch_kernels'),
                     ('CUDA_CACHE_PATH', 'cuda')):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    names compared whole."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def sync(device) -> None:
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run_cell(reg: Registry, workload: str, seed: int, seconds: float,
             trace: bool, device='cuda', t0: float = T0,
             overrides: dict = None, patch=None) -> dict:
    """One run of ``workload``; returns the result object.  ``overrides``
    replaces parts of the configuration and traffic (``{'config': {...},
    'traffic': {...}}``, for tests at small sizes); ``patch`` wraps the
    program's call of a unit (for tests that break it)."""
    import torch
    from benchmark import generator, stages, tracing
    cell = reg.workload(workload)
    config = dict(reg.config(cell['config']))
    traffic = dict(reg.traffic(cell['traffic']))
    limits = reg.limits(workload)
    for key, part in (overrides or {}).items():
        {'config': config, 'traffic': traffic}[key].update(part)
    device = torch.device(device)
    on_card = device.type == 'cuda'

    t_in = time.perf_counter()
    gen = generator.make(reg, config, traffic, seed, device)
    sync(device)
    t_prog = time.perf_counter()
    gen.setup_program()
    run = gen.run if patch is None else patch(gen.run)
    sync(device)
    t_warm = time.perf_counter()
    run(gen.unit(0)).cpu()
    sync(device)
    log(f'{workload}: set-up split: start to inputs {t_in - t0:.3f} s, '
        f'inputs {t_prog - t_in:.3f} s, program {t_warm - t_prog:.3f} s, '
        f'warm-up unit {time.perf_counter() - t_warm:.3f} s')
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t_setup = time.perf_counter()
    setup_s = t_setup - t0
    log(f'{workload}: set-up {setup_s:.3f} s, seed {seed}, device '
        f'{torch.cuda.get_device_name(device) if on_card else "cpu"}')

    # The window: a closed loop of one client.
    outputs, latency_ms, issue_ms = {}, [], []
    k = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_end = t_start
    while time.perf_counter() < deadline:
        inputs = gen.unit(k)
        t_sub = time.perf_counter()
        poses = run(inputs)
        t_ret = time.perf_counter()
        outputs[k] = poses.cpu()
        t_end = time.perf_counter()
        latency_ms.append(1e3 * (t_end - t_sub))
        issue_ms.append(1e3 * (t_ret - t_sub))
        k += 1
    window_s = t_end - t_start
    n_units = k
    scans = n_units * gen.scans_per_unit
    failed = sum(gen.failed(p) for p in outputs.values())
    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    log(f'{workload}: {n_units} units, {scans} scans in {window_s:.3f} s; '
        f'latency samples {len(latency_ms)}')

    rng = random.Random(seed)
    sample = sorted(rng.sample(range(n_units),
                               min(int(traffic['check_units']), n_units)))
    ctx, breakdown = None, None
    if trace and on_card and sample:
        records, win_ns = tracing.profile_units(gen, sample)
        ctx = tracing.context(records, win_ns, len(sample),
                              len(sample) * gen.scans_per_unit, issue_ms,
                              percentile(latency_ms, 50.0))
        breakdown = {'device_ops': tracing.device_ops(records),
                     'idle_gaps': tracing.idle_gaps(gen, sample[0])}
    elif trace:
        ctx = tracing.context([], 0, 0, 0, issue_ms, 0.0)
    if trace and sample:
        passes = stages.span_passes(gen, sample)
        if passes is not None:
            ctx.spans, ctx.counters = passes['names'], passes['counters']
            log(stages.stage_line(workload, passes))

    # The program's state goes before the reference runs.
    gen.drop_program()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    walk = ctx is not None and on_card
    numbers, bounds = gen.check(outputs, sample, walk=walk)
    log(f'{workload}: reference over units {sample} in '
        f'{time.perf_counter() - t_ref:.3f} s')
    if walk and bounds is not None:
        ctx.nn_bound_ms, ctx.nn_calls = bounds
        log(f'{workload}: walk of {sum(ctx.nn_calls.values())} pruned '
            f'1-NN calls')

    checks = {name: {'value': numbers[name], 'limit': limit}
              for name, limit in limits.items()}
    correct = (n_units > 0 and failed == 0
               and all(c['value'] <= c['limit'] for c in checks.values()))

    metrics = {}
    if trace:
        for m in reg.per_layer(workload):
            value = reg.reader(m['name'])(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        values = {
            'scans_per_s': scans / window_s if window_s > 0 else 0.0,
            'latency_ms_p95': (percentile(latency_ms, 95.0) if latency_ms
                               else math.inf),
            'setup_s': setup_s,
        }
        for m in reg.end_to_end(workload):
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}
    dev = {'platform': 'gpu' if on_card else 'cpu',
           'kind': torch.cuda.get_device_name(device) if on_card else 'cpu',
           'count': int(cell['chips']),
           'memory_peak_bytes': int(memory_peak)}
    if trace and ctx is not None:
        dev['busy_s'] = ctx.busy_ns / 1e9
        dev['window_s'] = ctx.window_ns / 1e9
    result = {'correct': bool(correct), 'attempted': scans, 'failed': failed,
              'metrics': metrics, 'device': dev}
    if breakdown is not None:
        result['breakdown'] = breakdown
    if latency_ms:
        log(f'{workload}: latency ms median {percentile(latency_ms, 50):.4f}'
            f' p95 {percentile(latency_ms, 95):.4f} over {len(latency_ms)} '
            f'units; host issue ms median {percentile(issue_ms, 50):.4f}')
    result['checks'] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    reg = Registry(ROOT)
    cell = reg.workload(args.workload)
    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        log(f'the program {PROGRAM}/ is not in the checkout {ROOT}')
        return 3
    cache_env(ROOT)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell['chips'])):
        log(f'{args.workload} needs {cell["chips"]} CUDA card(s); found '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 2
    result = run_cell(reg, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f'modules that must not load were loaded: {found}')
        return 4
    for name, c in result['checks'].items():
        log(f'check {name} {c["value"]!r} limit {c["limit"]!r}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
