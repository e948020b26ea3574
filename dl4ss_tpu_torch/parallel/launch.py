"""Starting the ranks of a parallel run on this machine.

`run_ranks(fn, world, args)` spawns `world` processes (start method
`spawn`), joins them into one `torch.distributed` group through a store
file in the run's temporary directory (no port is chosen ahead of the
ranks, so none can be taken in between) and runs `fn(*args)` on each; it
returns rank 0's result.
A rank that fails fails the run: the others are stopped and the call
raises. The backend is NCCL with one card a rank, gloo otherwise (the CPU,
or ranks that share a card, which NCCL refuses).
"""

from __future__ import annotations

import datetime
import os
import signal
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as multiprocessing

# how long a rank waits for the others, at the rendezvous and in every
# collective, before it fails
RENDEZVOUS_S = 600


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_entry(rank: int, world: int, store_path: str, backend: str,
                fn: Callable, args: Sequence, result_path: str) -> None:
    """Rank `rank` of `world`: join the group through the store file
    `store_path` (under NCCL on card `rank`), run fn(*args), and on rank 0
    save its result."""
    if rank:
        # one process prints, as a single-device run does
        sys.stdout = open(os.devnull, "w")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        # the ranks share this machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=f"file://{store_path}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
    try:
        out = fn(*args)
        if rank == 0:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              backend: str = "gloo", timeout: Optional[float] = None):
    """Run `fn(*args)` on `world` spawned ranks of one group and return
    rank 0's result. `fn` must be importable (a module-level function);
    `timeout` bounds the whole run (None: no bound), RENDEZVOUS_S each
    rank's wait for the others."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "rank0.pt")
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(r, world, store_path, backend, fn,
                                   tuple(args), result_path))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode for p in procs):
                    break             # one failed: stop the others
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks did not finish within {timeout} s")
                procs[0].join(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if failed:
            raise RuntimeError(f"ranks {sorted(failed)} of {world} exited "
                               f"with codes {list(failed.values())} (a rank "
                               f"stopped after another failed exits with "
                               f"-{int(signal.SIGTERM)})")
        # written by rank 0 of this call, so it is safe to unpickle
        return torch.load(result_path, weights_only=False)
