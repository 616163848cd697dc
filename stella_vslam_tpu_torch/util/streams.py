"""CUDA streams of the threaded System and the hand-over of tensors between them.

The tracker, the mapper and the loop closer each issue their device work on
a stream of their own, so that a keyframe event's kernels never queue behind
the tracker's in-flight frames. A tensor one thread makes and another reads
crosses with two marks:

* an event recorded on the producer's stream after the last write, which the
  consumer's stream waits on before its first read (`ready`, `consume`);
* `record_stream` of the consumer's stream on the tensor, so that the caching
  allocator does not hand its memory to the producer's stream while the
  consumer may still read it (a silent corruption, not a crash).

On the CPU every helper is a no-op and `stream_of` gives None.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def new_stream(device):
    """A stream of its own on a CUDA device, None on the CPU."""
    device = torch.device(device)
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on(stream):
    """Context: issue the enclosed device work on `stream` (None: as is)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def ready(device):
    """An event recorded on the current stream of a CUDA device (None on the
    CPU): the producer's mark after its last write."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def consume(tensors, event, device):
    """Make the current stream wait for `event` and mark each tensor as
    used by it (no-op on the CPU or without an event)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    s = torch.cuda.current_stream(device)
    if event is not None:
        s.wait_event(event)
    for t in tensors:
        t.record_stream(s)


def share(tensors, *streams):
    """Mark tensors as read by other streams (their work is ordered by the
    host already, so only the allocator needs to know)."""
    for s in streams:
        if s is None:
            continue
        for t in tensors:
            t.record_stream(s)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on the device without making the host wait: through
    pinned memory with a non-blocking copy on the current stream (a plain
    `.to(device)` from pageable memory synchronises the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
