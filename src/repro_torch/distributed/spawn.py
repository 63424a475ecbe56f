"""Run a function on N processes of one host, one mesh position each.

`run_ranks(fn, n)` starts n fresh Python processes (multiprocessing's
``spawn``), has each join a process group of n ranks through a ``file://``
rendezvous (no port to collide with another job's), calls ``fn(rank, n,
*args)`` and returns the results in rank order. A rank that raises fails
the call with that rank's traceback, after the other ranks are killed; so
does a rank that has not answered by the deadline (a hung collective), so
a fault ends the call rather than whatever runs it. ``fn`` must be
importable by name from a fresh process (a module-level function).

    from repro_torch.distributed.spawn import run_ranks
    results = run_ranks(my_rank_fn, 4, backend="gloo", deadline_s=300)
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def _rank_main(fn, rank, world, init_method, backend, timeout_s, threads,
               args, results):
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, *, args: Sequence = (),
              backend: str = "gloo", timeout_s: float = 120.0,
              deadline_s: float = 600.0, threads: Optional[int] = 1,
              workdir: Optional[str] = None) -> List[Any]:
    """``[fn(rank, world_size, *args) for rank in range(world_size)]``, each
    on a process of its own in a process group of ``backend``.
    ``timeout_s`` is the group's collective timeout (``init_process_group
    (timeout=)``), ``deadline_s`` the wall time after which the ranks still
    running are killed and the call raises; ``threads``: torch threads a
    rank; ``workdir``: where the rendezvous file goes (a new temporary
    directory by default)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    own_dir = workdir is None
    workdir = tempfile.mkdtemp(prefix="ranks-") if own_dir else workdir
    init = os.path.join(os.path.abspath(workdir),
                        f"rendezvous-{os.getpid()}-{time.time_ns()}")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, rank, world_size, "file://" + init, backend, timeout_s,
              threads, tuple(args), results))
        for rank in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    failure = None
    end = time.monotonic() + deadline_s
    try:
        while len(out) < world_size and failure is None:
            left = end - time.monotonic()
            if left <= 0:
                failure = (f"ranks {sorted(set(range(world_size)) - set(out))}"
                           f" did not finish within {deadline_s:.0f} s")
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead and results.empty():
                    time.sleep(1.0)   # a result may still be in flight
                    if results.empty():
                        failure = (f"ranks {dead} exited (codes "
                                   f"{[procs[r].exitcode for r in dead]}) "
                                   "without a result")
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if p.is_alive() and (failure is not None or len(out) < world_size):
                p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if os.path.exists(init):
            os.remove(init)
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, "
                           f"{world_size}): {failure}")
    return [out[r] for r in range(world_size)]
