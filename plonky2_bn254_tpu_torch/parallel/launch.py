"""Start SPMD ranks on one host and collect what each returns.

    results = launch.run(fn, world_size, *args, backend="gloo")

spawns `world_size` processes; rank r initialises the default process
group through a file in a fresh temporary directory (no port), calls
`fn(rank, world_size, *args)` and sends its return value back; `run`
returns the values in rank order.  `fn` must be importable by name (a
module-level function), and `args` and the results must pickle; a CPU
tensor in `args` reaches the ranks through shared memory.  A rank that
raises, dies or does not answer within `timeout` seconds fails the whole
run: every rank is stopped and `run` raises.  Nothing falls back to fewer
ranks.
"""

from __future__ import annotations

import multiprocessing
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch.distributed as dist


def _rank_main(fn, rank: int, world_size: int, init_file: str, backend: str,
               timeout: float, args: tuple, results) -> None:
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run(fn, world_size: int, *args, backend: str = "gloo", timeout: float = 600.0) -> list:
    """`fn(rank, world_size, *args)` on `world_size` spawned ranks; their
    results in rank order.  Raises RuntimeError if any rank fails."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, f"{tmp}/init", backend, timeout, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world_size:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = {r: p.exitcode for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got}
                    if dead:
                        raise RuntimeError(f"launch.run: ranks died (rank: exit code) {dead}") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"launch.run: no answer from ranks "
                                           f"{sorted(set(range(world_size)) - set(got))} "
                                           f"within {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"launch.run: rank {rank} failed\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                if len(got) < world_size:
                    p.terminate()
                p.join(timeout=60)
    return [got[r] for r in range(world_size)]
