"""Timing on a CUDA device.

PyTorch returns from a launch before the device has run it, and a kernel of
a few microseconds launched back to back from Python is timed at the host's
launch rate unless the device is kept busy meanwhile. `device_ms` therefore
queues each window's calls behind a spin kernel that outlasts their enqueue,
so its CUDA events bracket back-to-back device work; `cuda_ms` times the
calls as the host issues them, which is what a caller of a whole path waits
for. `device_busy` reads a whole path's device time from torch.profiler as
the sum of its kernels' durations, whatever the host's launch rate.
"""

from __future__ import annotations

import statistics
import time

import torch


def cuda_ms(fn, reps, warmup=1, windows=3):
    """Milliseconds per call of fn() on the current stream: the mean over
    `reps` calls in each of `windows` windows, after `warmup` calls. Returns
    (median window, all windows)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(statistics.median(times)), times


def device_ms(fn, reps, warmup=2, windows=3):
    """Device milliseconds per call of fn(), without the host's launch
    rate: each window's calls are queued behind a spin kernel that lasts
    longer than the host takes to enqueue them, so the events bracket
    back-to-back device work. Returns (median window, all windows, host
    enqueue ms per call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    stop.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(stop)
    times = []
    for _ in range(windows):
        torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms * reps + 1)))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(statistics.median(times)), times, host_ms


def device_busy(fn, calls=1):
    """torch.profiler over `calls` calls of fn(): (device busy ms per call,
    wall ms per call, kernel rows). The busy time is the sum of the kernels'
    own durations, so it does not depend on how fast the host issues them;
    device spans of annotated ranges are not kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # a record_function range (optimizer.step has one) is also recorded on
    # the device, as a user annotation spanning kernels counted already
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / calls
    return busy_ms, wall_ms, rows


def spread(times):
    """The windows of one measurement as text."""
    return '/'.join(f'{t:.3f}' for t in times)


def card_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    import subprocess
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
