"""Profiling (the port of `dl4ss_tpu/utils/profiling.py`).

  * `profile_trace(dir)` wraps a block in a `torch.profiler` trace (the
    host, and the card's kernels when CUDA is available) and writes it as
    a Chrome trace, `<dir>/trace.json` (chrome://tracing, Perfetto);
  * `StepTimer` measures the steady-state time of a chained step: the
    iterations feed each other and the clock stops once the last one is
    done, `torch.cuda.synchronize()` on the card, the fetch on the CPU;
  * `span(name)` marks a phase of a step or a request (`dl4ss.<name>`) in
    whatever trace the profiler is collecting, and costs an attribute
    read when it is not.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch
from torch import nn
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None,
                  host_tracer_level: int = 2):
    """Trace the block; yields `log_dir` (default: `dl4ss_trace` under the
    temporary directory) and writes `log_dir/trace.json` when it ends.
    `host_tracer_level` >= 2 also records the operators' input shapes."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "dl4ss_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                record_shapes=host_tracer_level >= 2) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def span(name: str):
    """The phase `name` of a step or a request, as the host op
    `dl4ss.<name>` of the profiler's trace, which shares its clock with
    the card's activity there. It is an op and not a user annotation
    (`record_function`): the profiler mirrors an annotation onto the
    card's timeline, where a reader of device time would count it as work
    and as a kernel. Outside a profiler it is one shared no-op context;
    the flag is read at each call, because the profiler sets it when it
    starts."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast("dl4ss." + name)
    return _NO_SPAN


def _first_tensor(x):
    """The first tensor of a tensor, module, dict, list, tuple or
    dataclass (a train state), or None."""
    if torch.is_tensor(x):
        return x
    if isinstance(x, nn.Module):
        return next(x.parameters(), None)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _finish(x) -> None:
    """Wait for the chain's last iteration: synchronize its card, or read
    its first tensor back on the CPU."""
    t = _first_tensor(x)
    if t is None:
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    else:
        float(t.detach().float().sum())


class StepTimer:
    """Measure ms/step of `fn(state) -> state`-shaped chains honestly."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup

    def time_chain(self, fn: Callable, init, iters: int = 20,
                   fetch: Optional[Callable] = None) -> float:
        """Returns mean ms per iteration. `fetch(x)` forces the chain
        (default: synchronize the card its first tensor lives on, or sum
        that tensor on the CPU)."""
        fetch = fetch or _finish
        x = init
        for _ in range(self.warmup):
            x = fn(x)
        fetch(x)
        t0 = time.perf_counter()
        for _ in range(iters):
            x = fn(x)
        fetch(x)
        return (time.perf_counter() - t0) / iters * 1000.0
