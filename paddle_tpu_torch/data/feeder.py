"""Host-to-device feeding with prefetch (port of
`paddle_tpu.data.feeder`).

`DataFeeder` converts batches to stacked numpy columns on a worker
thread while the device computes, then moves each column to the torch
device: on cuda through pinned host memory with `non_blocking=True`, so
the copy is queued on the stream and the host goes on. `device=None`
means cuda (raises without a card), as every entry point of the port.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.data.batch import stack_columns


def to_device(batch, device: torch.device):
    """Every column of a batch (a tuple, list or dict of numpy arrays or
    tensors, or one array) as a tensor on `device`; on cuda through
    pinned memory, non_blocking."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(x, device) for x in batch)
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(batch))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DataFeeder:
    """Iterate device-ready batches from a batch-reader.

    convert_fn: list-of-samples -> tuple of numpy arrays (default: stack
    the tuple columns). prefetch: converted batches kept ahead of the
    consumer by the worker thread."""

    def __init__(self, convert_fn: Optional[Callable] = None,
                 device=None, prefetch: int = 2):
        self.convert_fn = convert_fn or stack_columns
        self.device = resolve_device(device)
        self.prefetch = prefetch

    def __call__(self, batch_reader) -> Iterator[Any]:
        end = object()
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        errors = []

        def worker():
            try:
                for raw in batch_reader():
                    q.put(self.convert_fn(raw))
            except BaseException as e:  # handed to the consumer below
                errors.append(e)
            finally:
                q.put(end)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            host_batch = q.get()
            if host_batch is end:
                if errors:
                    raise errors[0]
                return
            yield to_device(host_batch, self.device)


def prefetch_to_device(iterator: Iterator, size: int = 2,
                       device=None) -> Iterator:
    """Keep `size` batches already moved to `device` (None -> cuda) ahead
    of the consumer: the next batch's copy is queued on the stream while
    the current step computes. A batch already on the device passes
    through."""
    dev = resolve_device(device)
    buf = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(size):
            buf.append(to_device(next(it), dev))
    except StopIteration:
        pass
    while buf:
        nxt = buf.popleft()
        try:
            buf.append(to_device(next(it), dev))
        except StopIteration:
            pass
        yield nxt
