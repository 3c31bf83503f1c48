"""Device time by program span (`core.spans.device_by_span`) on Chrome
events written by hand."""

import pytest

from benchmark.core.spans import device_by_span

MAIN, AUTOGRAD, STREAM = 1, 2, 7


def span(name, ts, dur, tid=MAIN):
    return {'ph': 'X', 'cat': 'user_annotation', 'name': name, 'ts': ts,
            'dur': dur, 'tid': tid}


def launch(corr, ts, tid=MAIN):
    return {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
            'ts': ts, 'dur': 1, 'tid': tid, 'args': {'correlation': corr}}


def kernel(corr, ts, dur, cat='kernel'):
    return {'ph': 'X', 'cat': cat, 'name': f'k{corr}', 'ts': ts, 'dur': dur,
            'tid': STREAM, 'args': {'correlation': corr}}


def test_innermost_span_and_the_spans_around_it():
    events = [span('bench.dispatch', 0, 300), span('outer', 0, 200),
              span('inner', 10, 40),
              launch(1, 20), kernel(1, 25, 5),
              launch(2, 60), kernel(2, 61, 10, 'gpu_memcpy'),
              launch(3, 250), kernel(3, 251, 4, 'gpu_memset')]
    got = device_by_span(events, 2)
    assert got['units'] == 2
    assert got['spans'] == {'inner': [pytest.approx(5e-6), 1],
                            'outer': [pytest.approx(10e-6), 1]}
    assert got['under'] == {'inner': [pytest.approx(5e-6), 1],
                            'outer': [pytest.approx(15e-6), 2]}
    # under no program span: the benchmark's own does not count
    assert got['other'] == [pytest.approx(4e-6), 1]


def test_a_launch_from_a_thread_without_spans_takes_the_open_one():
    """Autograd's thread issues the backward's kernels while the main
    thread sits in the backward span."""
    events = [span('train.step', 0, 500), span('train.forward', 0, 100),
              span('train.backward', 100, 300),
              launch(1, 50), kernel(1, 60, 10),
              launch(2, 150, AUTOGRAD), kernel(2, 160, 20),
              launch(3, 350, AUTOGRAD), kernel(3, 360, 30)]
    got = device_by_span(events, 1)
    assert got['spans'] == {'train.forward': [pytest.approx(10e-6), 1],
                            'train.backward': [pytest.approx(50e-6), 2]}
    assert got['under']['train.step'] == [pytest.approx(60e-6), 3]
    assert got['other'] == [0.0, 0]


def test_two_batches_in_flight_go_by_their_launch():
    """Batch one's kernels run after batch two's spans opened: they stay
    batch one's."""
    events = [span('mtcnn.onet', 0, 10), launch(1, 5),
              span('mtcnn.pnet', 20, 10), launch(2, 25),
              kernel(1, 26, 8), kernel(2, 34, 6)]
    got = device_by_span(events, 2)
    assert got['spans'] == {'mtcnn.onet': [pytest.approx(8e-6), 1],
                            'mtcnn.pnet': [pytest.approx(6e-6), 1]}


def test_an_operation_without_its_launch_is_other():
    got = device_by_span([span('a', 0, 10), kernel(9, 5, 3)], 1)
    assert got['spans'] == {} and got['other'] == [pytest.approx(3e-6), 1]
