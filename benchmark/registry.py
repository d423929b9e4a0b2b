"""Finds a cell's parts by name, from files alone.

``BENCHMARK.json`` at the root pairs a configuration with a traffic mix
in each of its ``workloads``.  The rest lies under ``benchmark/``:

* ``configs/<config>.json``: the configuration, at the path its entry's
  ``file`` names;
* ``traffic/<traffic>.json``: the traffic mix, plain data, whose
  ``kind`` names the generator that reads it;
* ``kinds/<kind>.py``: the generator of a kind of traffic, a module with
  a class ``Kind`` (``generator.py`` says what it provides);
* ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell;
* ``metrics/<metric>.py``: one reader a per-layer metric, a module with
  ``read(ctx) -> float | None``.

Adding a cell, a configuration, a traffic mix, a kind of traffic or a
per-layer metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = 'benchmark'


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Registry:
    """The benchmark of the checkout at ``root``."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = load_json(os.path.join(root, 'BENCHMARK.json'))

    def workload(self, name: str) -> dict:
        for w in self.spec['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')

    def config(self, name: str) -> dict:
        for c in self.spec['configs']:
            if c['name'] == name:
                return load_json(os.path.join(self.root, c['file']))
        raise KeyError(f'no configuration {name!r} in BENCHMARK.json')

    def _file(self, folder: str, name: str, ext: str) -> str:
        return os.path.join(self.root, BENCH_DIR, folder, name + ext)

    def traffic(self, name: str) -> dict:
        return load_json(self._file('traffic', name, '.json'))

    def limits(self, workload: str) -> dict:
        return load_json(self._file('limits', workload, '.json'))

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.spec['end_to_end']
                if workload in m.get('workloads', [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        return [m for m in self.spec['per_layer']
                if workload in m.get('workloads', [workload])]

    def _module(self, folder: str, name: str):
        path = self._file(folder, name, '.py')
        spec = importlib.util.spec_from_file_location(
            f'benchmark_{folder}_{name.replace(".", "_").replace("-", "_")}',
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def kind(self, name: str):
        """The module of the traffic kind ``name``."""
        return self._module('kinds', name)

    def reader(self, metric: str) -> Callable[[object], Optional[float]]:
        return self._module('metrics', metric).read
