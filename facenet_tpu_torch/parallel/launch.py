"""Start a grid's ranks in one call: the launcher the tests and the smoke
run share.

`spawn(fn, world_size, backend, device, args)` starts `world_size`
processes with the spawn start method, joins them into one process group
on a free local port (`mesh.init_distributed`), calls ``fn(device,
*args)`` in each with that rank's device, and returns every rank's result
in rank order. `fn` must be importable by name (a module-level function),
and its arguments and result picklable: numpy arrays and numbers, not
tensors (torch's queue would hand a tensor over in shared memory that the
exiting rank takes with it). A rank that raises fails the call
with its traceback; a group that does not finish within `timeout` seconds
is killed and fails it too, so a collective that hangs costs its caller no
more than that.
"""

from __future__ import annotations

import os
import queue as queue_mod
import time
import traceback

import torch
import torch.multiprocessing as mp


def _rank_main(rank, world_size, address, backend, device, fn, args,
               threads, timeout, results):
    import torch.distributed as dist

    from facenet_tpu_torch.parallel import mesh

    try:
        if threads:
            torch.set_num_threads(int(threads))
        device = mesh.init_distributed(
            coordinator_address=address, num_processes=world_size,
            process_id=rank, backend=backend, device=device,
            timeout=timeout)
        try:
            value = fn(device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size, backend='gloo', device='cpu', args=(),
          timeout=300, threads=None):
    """Run ``fn(device, *args)`` on `world_size` spawned ranks.

    :param backend: 'gloo' or 'nccl'
    :param device: 'cpu' or 'cuda' (rank r on card r % device_count)
    :param timeout: seconds for the whole group, start-up included
    :param threads: torch's intra-op threads in each rank
    :return: the ranks' results, rank 0 first
    :raises RuntimeError: when a rank raised or the group timed out
    """
    from facenet_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    address = f'127.0.0.1:{free_port()}'
    # the children are started with this interpreter's environment; one
    # torchrun set for this process must not leak into the group
    saved = {k: os.environ.pop(k) for k in ('WORLD_SIZE', 'RANK',
                                            'LOCAL_RANK') if k in os.environ}
    try:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world_size, address, backend,
                                   str(device), fn, tuple(args), threads,
                                   timeout, results))
                 for rank in range(world_size)]
        for proc in procs:
            proc.start()
    finally:
        os.environ.update(saved)

    deadline = time.monotonic() + timeout
    values, failure = {}, None
    try:
        # drain the queue before joining: a child blocks on a full pipe
        while len(values) < world_size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f'the group did not finish within {timeout} s'
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    failure = f'a rank exited with code {dead[0]}'
                continue
            if ok:
                values[rank] = value
            else:
                failure = f'rank {rank} failed:\n{value}'
    finally:
        for proc in procs:
            proc.join(timeout=5 if failure is None else 0.1)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        results.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [values[rank] for rank in range(world_size)]
