"""What the benchmark imports: never JAX or the JAX package, and the plain
reference nothing of the program.  Top-level module names are compared
whole, since the program's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from benchmark.registry import ROOT

BENCH = os.path.join(ROOT, 'benchmark')
JAX = {'jax', 'jaxlib', 'flax', 'laser_slam_tpu'}
PROGRAM = 'laser_slam_tpu_torch'


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {name.split('.')[0] for name in _imports(path)}
        assert not tops & JAX, (path, tops & JAX)


def _closure(module):
    """The benchmark's modules that ``module`` imports, itself included."""
    seen, todo = set(), [module]
    while todo:
        m = todo.pop()
        if m in seen:
            continue
        seen.add(m)
        path = os.path.join(ROOT, *m.split('.')) + '.py'
        for name in _imports(path):
            if name.split('.')[0] == 'benchmark' and name != 'benchmark':
                todo.append(name)
    return seen


def test_the_reference_imports_nothing_of_the_program():
    for m in _closure('benchmark.reference'):
        path = os.path.join(ROOT, *m.split('.')) + '.py'
        tops = {name.split('.')[0] for name in _imports(path)}
        assert PROGRAM not in tops, m
        assert tops <= {'__future__', 'math', 'typing', 'torch',
                        'benchmark'}, (m, tops)


def test_a_run_loads_no_jax_module():
    code = ('from benchmark import run; from benchmark.registry import '
            'Registry; from benchmark.tests.sizes import small; '
            'reg = Registry(); w = "fleet-odom-outdoor"; '
            'r = run.run_cell(reg, w, 3, 0.2, False, device="cpu", '
            'overrides=small(reg, w)); assert r["correct"]; '
            'print(run.forbidden_modules())')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'
