"""Device prefetch: overlap host-to-device copies with compute
(counterpart of gcm_tpu/data/prefetch.py).

A training loop that copies each host batch inline serialises the copy
with the step. `prefetch_to_device` wraps any iterator of host batches
(nested dicts, lists and tuples of numpy arrays, numbers or tensors) with a
background thread that stages up to `size` batches on the card ahead of the
consumer: each leaf is pinned, copied with non_blocking=True on the
thread's own CUDA stream, and an event is recorded behind the copies. The
consumer's stream waits on that event before the batch is handed out, and
every tensor is marked with `record_stream` for the consumer's stream, so
that the caching allocator does not hand its memory out again while the
consumer's kernels may still read it. An exception of the iterator is
raised in the consumer; closing the generator stops the thread.

On device="cpu" the leaves are only converted to tensors.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from gcm_tpu_torch.device import resolve_device


class _Stop:
    pass


class _Raise:
    def __init__(self, exc):
        self.exc = exc


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _map(tree, out.append)
    return out


def _as_tensor(leaf):
    return leaf if torch.is_tensor(leaf) else torch.as_tensor(np.asarray(leaf))


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Yields the items of `iterator` as tensors on `device` (default the
    card; raises without one), staging up to `size` items ahead from a
    background thread.

    size: prefetch depth (2 overlaps one copy with one step; more only
        helps a jittery producer).
    The device is resolved at the call; the thread starts at the first
    item asked for."""
    if size < 1:
        raise ValueError(f"prefetch depth {size} < 1")
    return _prefetch(iterator, size, resolve_device(device))


def _prefetch(iterator, size, dev):
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    cuda = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(device=dev) if cuda else None

    def stage(item):
        host = _map(item, _as_tensor)
        if not cuda:
            return host, None
        host = _map(host, lambda t: t if t.is_cuda else t.pin_memory())
        with torch.cuda.stream(copy_stream):
            out = _map(host, lambda t: t.to(dev, non_blocking=True))
            event = torch.cuda.Event()
            event.record(copy_stream)
        return out, event

    def put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(stage(item)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            put(_Raise(e))
            return
        put(_Stop())

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            got = q.get()
            if isinstance(got, _Stop):
                return
            if isinstance(got, _Raise):
                raise got.exc
            out, event = got
            if event is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(event)
                for t in _leaves(out):
                    t.record_stream(consumer)
            yield out
    finally:
        stop.set()
        thread.join()
