"""BENCHMARK.json against its contract, and every cell loading from its
files alone."""

import importlib
import json
import re

import pytest

from benchmark.core import manifest

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
M = manifest.load()
CELLS = [w['name'] for w in M['workloads']]


def test_top_level_keys():
    assert set(M) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert M['command'] == ['python3', 'benchmark/run.py']
    assert M['paths'] == ['benchmark']
    assert 1 <= M['run_seconds'] <= 51


def test_names_and_units():
    names = [c['name'] for c in M['configs']] + CELLS + [
        m['name'] for m in M['end_to_end'] + M['per_layer']]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in M['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4) and 0 < len(w['why']) <= 200
    for m in M['end_to_end'] + M['per_layer']:
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')


def test_bounds():
    for m in M['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    assert next(m for m in M['end_to_end']
                if m['name'] == 'setup_s')['bound'] <= 0.25


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (M['run_seconds'] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize('cell', CELLS)
def test_each_cell_reports_what_its_metrics_move(cell):
    c = manifest.cell(cell)
    e2e = {m['name'] for m in c.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m['moves'] in e2e, (cell, m['name'])


@pytest.mark.parametrize('cell', CELLS)
def test_a_cell_loads_from_its_files(cell):
    c = manifest.cell(cell)
    assert c.config and c.traffic and c.limits
    importlib.import_module(f"benchmark.drivers.{c.traffic['driver']}")
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m['name']))


def test_configs():
    for c in M['configs']:
        path = manifest.ROOT / c['file']
        assert path.is_file() and c['file'].startswith('benchmark/')
        with open(path) as f:
            config = json.load(f)
        # the one departure from the source: the repository's stem padding
        assert c['reduced'] == config['reduced'] == ['stem_conv2d_2b_padding']
        assert config['stem_conv2d_2b_padding'] == 'VALID'
        assert c['source'].startswith('https://')
