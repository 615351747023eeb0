"""Frame prefetching off the critical path (port of runtime/prefetch.py).

``PrefetchIterator`` loads frames ``depth`` ahead in a worker thread, so the
online loop never waits on disk or rendering. ``DevicePrefetchIterator``
also packs each frame (``engine.pack``) and, on CUDA, copies it to the card
in the worker thread: the bytes go into a pinned host buffer, the copy runs
on the iterator's own CUDA stream and an event is recorded after it.
The consumer makes its current stream wait on that event (a device-side
wait: the host does not block) and records the buffer's use on that stream,
so the caching allocator cannot hand its memory out again while the frame's
work is queued. A pinned buffer is refilled only after its last copy has
completed. On the CPU the packed frame is handed on as a CPU tensor.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.runtime.trace import Tracer

_SENTINEL = object()
_UNTRACED = Tracer("cpu")


class _Worker:
    """A daemon thread that puts ``produce(i, item)`` for each item of a
    source into a bounded queue, and the sentinel at the end; its error is
    raised on the consumer side. ``close`` stops it early. With a tracer
    each item is the span ``prefetch`` of frame ``first + i``, around
    ``prefetch.source`` (the wait for the source; its end is the frame's
    receipt), what ``produce`` records and ``prefetch.put``."""

    def __init__(self, source: Iterable, depth: int, produce, tracer: Tracer = _UNTRACED,
                 first: int = 0):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._produce = produce
        self._trace, self._first = tracer, first
        self._thread = threading.Thread(target=self._run, args=(source,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, source) -> None:
        tr = self._trace
        try:
            it = iter(source)
            for i in itertools.count():
                frame = self._first + i
                with tr.span("prefetch", frame) as span:
                    with tr.span("prefetch.source", frame) as wait:
                        item = next(it, _SENTINEL)
                    if item is _SENTINEL:
                        wait.cancel()
                        span.cancel()
                        return
                    out = self._produce(i, item)
                    tr.set_origin(frame, span.id)
                    with tr.span("prefetch.put", frame):
                        if not self._put(out):
                            return
        except BaseException as e:  # loader errors surface on the consumer side
            self._error = e
        finally:
            self._put(_SENTINEL)

    def depth(self) -> int:
        """Items waiting in the queue (no wait)."""
        return self._queue.qsize()

    def get(self):
        """The next item, or the sentinel after the last (raising the
        worker's error, if it had one)."""
        item = self._queue.get()
        if item is _SENTINEL and self._error is not None:
            raise self._error
        return item

    def items(self) -> Iterator:
        while True:
            item = self.get()
            if item is _SENTINEL:
                return
            yield item

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)


class PrefetchIterator:
    """Wrap any frame iterable with a ``depth``-deep background queue."""

    def __init__(self, source: Iterable, depth: int = 2):
        self._worker = _Worker(source, depth, lambda i, item: item)

    def __iter__(self) -> Iterator:
        return self._worker.items()

    def close(self) -> None:
        self._worker.close()


def prefetch(source: Iterable, depth: int = 2) -> Iterable:
    """``for frame in prefetch(dataset, depth=2): ...``"""
    if depth <= 0:
        return source
    return PrefetchIterator(source, depth)


class _PinnedSlot:
    """A reusable pinned host buffer and the event of its last copy."""

    def __init__(self):
        self.host: Optional[torch.Tensor] = None
        self.copied: Optional[torch.cuda.Event] = None


class DevicePrefetchIterator:
    """Packs and uploads each frame ``depth`` frames ahead in a worker thread.

    Yields (frame, packed): ``packed`` is the frame's ``engine.pack`` buffer
    as a uint8 tensor on the engine's device. Frame indices are assigned in
    iteration order from ``engine.frame_idx``: feed every yielded frame to
    ``engine.process(frame, packed=packed)`` once, in order.

    With the engine's tracing on (``engine.trace``), the worker records the
    spans ``prefetch.pack``, ``prefetch.slot_wait`` (the wait for a pinned
    buffer's last copy) and ``prefetch.upload`` inside each frame's
    ``prefetch`` span, and the consumer the span ``prefetch.wait`` (its
    parent that ``prefetch`` span) and the counter ``prefetch.queue``, the
    frames waiting in the queue when it asks for the next.
    """

    def __init__(self, source: Iterable, engine, depth: int = 2):
        self._engine = engine
        self._start = int(engine.frame_idx)
        self._device = engine.device
        self._cuda = self._device.type == "cuda"
        self._trace = getattr(engine, "trace", _UNTRACED)
        if self._cuda:
            self._stream = torch.cuda.Stream(self._device)
            self._ring: List[_PinnedSlot] = [_PinnedSlot() for _ in range(max(depth, 1) + 1)]
        self._worker = _Worker(source, depth, self._pack_and_upload, self._trace, self._start)

    def _pack_and_upload(self, i: int, frame):
        tr, index = self._trace, self._start + i
        with tr.span("prefetch.pack", index):
            packed = self._engine.pack(frame, frame_index=index)
        if not self._cuda:
            return frame, torch.from_numpy(packed), None
        slot = self._ring[i % len(self._ring)]
        with tr.span("prefetch.slot_wait", index):
            if slot.copied is not None:
                slot.copied.synchronize()   # this worker waits, never the consumer
        with tr.span("prefetch.upload", index):
            if slot.host is None or slot.host.numel() < packed.size:
                slot.host = torch.empty(packed.size, dtype=torch.uint8, pin_memory=True)
            host = slot.host[:packed.size]
            np.copyto(host.numpy(), packed)
            with torch.cuda.stream(self._stream):
                on_device = host.to(self._device, non_blocking=True)
                slot.copied = torch.cuda.Event()
                slot.copied.record(self._stream)
        return frame, on_device, slot.copied

    def __iter__(self) -> Iterator:
        tr = self._trace
        for index in itertools.count(self._start):
            depth = self._worker.depth()
            with tr.span("prefetch.wait", index) as wait:
                item = self._worker.get()
                wait.parent = tr.origin(index) or wait.parent
            if item is _SENTINEL:
                wait.cancel()
                return
            tr.set_origin(index, wait.parent)
            tr.counter("prefetch.queue", index, depth)
            frame, packed, copied = item
            if copied is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(copied)
                packed.record_stream(stream)
            yield frame, packed

    def close(self) -> None:
        self._worker.close()


def device_prefetch(source: Iterable, engine, depth: int = 2):
    """``for frame, packed in device_prefetch(ds, engine): engine.process(
    frame, packed=packed)``: pack and upload off the critical path. The
    result has ``close()``, which stops the worker early. ``depth <= 0``
    yields (frame, None) in order, and ``process`` packs the frame."""
    if depth <= 0:
        return ((frame, None) for frame in source)
    return DevicePrefetchIterator(source, engine, depth)
