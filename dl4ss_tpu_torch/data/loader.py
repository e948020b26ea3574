"""Host -> device feeding with prefetch (the port of
`dl4ss_tpu/data/loader.py`).

The reference rebuilds its Python generator every batch and blocks the GPU
on CPU STFTs (Torch_multi/main_run.py:457-458). Device-resident banks make
that moot at WSJ0 scale; for streaming corpora, `device_prefetch` overlaps
the host -> device copies with the compute: each batch is staged in pinned
host memory and copied on a side stream, `depth` batches in flight.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch

from dl4ss_tpu_torch.device import resolve_device


def to_pinned(batch: Mapping) -> dict:
    """The batch (a dict of numpy arrays) as tensors in pinned
    (page-locked) host memory, which a copy can read while the host goes
    on."""
    out = {}
    for k, a in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(a))
        out[k] = torch.empty(t.shape, dtype=t.dtype,
                             pin_memory=True).copy_(t)
    return out


def device_prefetch(batches: Iterable[Mapping], depth: int = 2,
                    device=None) -> Iterator[dict]:
    """Yield each batch of `batches` (dicts of numpy arrays, as
    `StreamingTreeSampler.batches` makes them) as tensors on `device`
    (default `cuda`; raises without a GPU unless device='cpu'), with the
    copies of the next `depth` batches in flight.

    On CUDA each batch is staged in pinned memory and copied with
    non_blocking=True on a side stream; an event marks the end of its
    copies, and before a batch is yielded the consumer's stream waits on
    that event, and every tensor of it is marked as used by that stream
    (`record_stream`), so the caching allocator does not hand its memory
    to another tensor while the consumer's work on it is queued. A pinned
    buffer is never reused: each batch gets its own, held here until the
    batch is yielded (and by the pinned allocator until the copy that
    reads it is done). On the CPU the batches are only converted to
    tensors."""
    dev = resolve_device(device)
    it = iter(batches)
    if dev.type != "cuda":
        for b in it:
            yield {k: torch.as_tensor(np.asarray(a)) for k, a in b.items()}
        return
    side = torch.cuda.Stream(device=dev)
    consumer = torch.cuda.current_stream(dev)
    queue = collections.deque()

    def put(b):
        host = to_pinned(b)
        with torch.cuda.stream(side):
            out = {k: t.to(dev, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        return out, done, host

    def take():
        out, done, _host = queue.popleft()
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        return out

    for b in itertools.islice(it, depth):
        queue.append(put(b))
    for b in it:
        queue.append(put(b))
        yield take()
    while queue:
        yield take()
