"""BENCHMARK.json and the files it names: a cell is found by its name, its
configuration, traffic mix, limits and metric readers by theirs."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / 'benchmark'


def load(root=ROOT):
    with open(Path(root) / 'BENCHMARK.json') as f:
        return json.load(f)


def _applies(metric, cell, reported):
    """Whether `metric` is reported in `cell`: its own ``workloads``, or,
    without one, every cell that reports what it moves (or every cell)."""
    if 'workloads' in metric:
        return cell in metric['workloads']
    if 'moves' in metric:
        return metric['moves'] in reported
    return True


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def cell(name, manifest=None, root=ROOT):
    """The cell `name` with everything it reads loaded."""
    manifest = manifest or load(root)
    root = Path(root)
    work = next((w for w in manifest['workloads'] if w['name'] == name),
                None)
    if work is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    entry = next(c for c in manifest['configs'] if c['name'] == work['config'])
    with open(root / entry['file']) as f:
        config = json.load(f)
    with open(root / 'benchmark' / 'traffic' / f"{work['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / 'benchmark' / 'limits' / f'{name}.json') as f:
        limits = json.load(f)
    e2e = [m for m in manifest['end_to_end'] if _applies(m, name, ())]
    reported = {m['name'] for m in e2e}
    per_layer = [m for m in manifest['per_layer']
                 if _applies(m, name, reported)]
    return Cell(name, work['config'], config, work['traffic'], traffic,
                int(work['chips']), limits, e2e, per_layer)


def reader(metric_name, root=ROOT):
    """The `read(run)` function of ``benchmark/metrics/<name>.py``."""
    path = Path(root) / 'benchmark' / 'metrics' / f'{metric_name}.py'
    spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + metric_name.replace('.', '_').replace('-', '_'),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(traffic):
    """The driver module a traffic file names."""
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
