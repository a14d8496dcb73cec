"""Every copy of the pipeline's input volumes to a device: ``upload`` and
``upload_start`` take an array or a tensor, count the bytes it takes from
the host (``upload.bytes``) and open the ``sift3d.upload`` span (see
``utils/trace``); ``image_dtype`` is the API's rule for the type an image
is uploaded as.

A pageable ``.to(device)`` of a volume stack holds the caller for the
whole copy, and the card has nothing to do meanwhile. Here a copy from
the host (a CPU tensor) to a CUDA device goes through a process-wide ring
of ``RING_DEPTH`` pinned buffers of ``CHUNK_BYTES``, allocated on first
use and reused by every later call. The source is cut into contiguous
pieces of at most a buffer each (``pieces``); for each piece the host
waits for the last copy out of its buffer, copies the piece in (torch's
CPU copy, which also converts the type, e.g. int16 to float32) and
queues the buffer's copy to the device on a copy stream of its own, so
that staging the next piece overlaps the copy of this one. Nothing is
kept of the caller's data: every call copies every byte. Every other
copy (to a CPU destination, or of a tensor already on a device) is the
plain ``.to()``, made contiguous.

Stream safety: the destination is allocated on the caller's thread, on
its current stream; the copy stream first waits for an event recorded
there after the allocation, and the caller's stream waits for the
upload's last event before any use. No ``record_stream``, and no host
sync of the caller's stream.

``upload_start`` runs an upload on the one upload worker thread and
returns at once with a ``Pending``: uploads run there in the order they
were started, so a caller can start the upload of the next batch before
it works on this one.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import math
import threading

import numpy as np
import torch
from torch.profiler import record_function

from ..utils import trace

CHUNK_BYTES = 64 << 20      # one ring buffer
RING_DEPTH = 4              # buffers in the ring

_lock = threading.Lock()
_ring_obj = None
_streams: dict = {}
_worker_obj = None


def pieces(shape, itemsize: int, chunk: int):
    """Index tuples that cut a C-ordered array of ``shape`` into
    contiguous pieces of at most ``chunk`` bytes: whole rows of the
    first axis whose rows fit, one index of each axis before it."""
    shape = tuple(shape)
    d = 0
    while d < len(shape) - 1 and \
            math.prod(shape[d + 1:]) * itemsize > chunk:
        d += 1
    rows = max(chunk // (math.prod(shape[d + 1:]) * itemsize), 1)
    for outer in itertools.product(*map(range, shape[:d])):
        for a in range(0, shape[d], rows):
            yield outer + (slice(a, min(a + rows, shape[d])),)


class Ring:
    """``RING_DEPTH`` byte buffers of ``CHUNK_BYTES`` (pinned when
    ``pin``), the fence of the last copy out of each, and the lock that
    one upload holds for its whole copy."""

    def __init__(self, pin: bool):
        self.chunk = CHUNK_BYTES
        self.bufs = [torch.empty(self.chunk, dtype=torch.uint8,
                                 pin_memory=pin) for _ in range(RING_DEPTH)]
        self.fences = [None] * RING_DEPTH
        self.lock = threading.Lock()

    def copy(self, src: torch.Tensor, dst: torch.Tensor, send) -> None:
        """Copy the host tensor ``src`` into the contiguous ``dst`` of its
        shape, piece by piece through the buffers in turn. ``send(d, b)``
        copies the staged piece ``b`` to ``dst``'s piece ``d`` and returns
        the fence (an object with ``synchronize()``) that the host waits
        on before the buffer is written again, or None when the copy is
        already done."""
        size = dst.element_size()
        with self.lock:
            for k, idx in enumerate(pieces(dst.shape, size, self.chunk)):
                j = k % len(self.bufs)
                if self.fences[j] is not None:
                    self.fences[j].synchronize()
                d = dst[idx]
                b = self.bufs[j][:d.numel() * size].view(dst.dtype)
                b = b.view(d.shape)
                b.copy_(src[idx])
                self.fences[j] = send(d, b)


def ring() -> Ring:
    """The process-wide ring, made on first use (pinned where there is a
    card)."""
    global _ring_obj
    with _lock:
        if _ring_obj is None:
            _ring_obj = Ring(pin=torch.cuda.is_available())
        return _ring_obj


def _copy_stream(device: torch.device):
    with _lock:
        if device not in _streams:
            _streams[device] = torch.cuda.Stream(device=device)
        return _streams[device]


def _worker() -> concurrent.futures.ThreadPoolExecutor:
    global _worker_obj
    with _lock:
        if _worker_obj is None:
            _worker_obj = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sift3d-upload")
        return _worker_obj


def image_dtype(data):
    """The type an image (an array or a tensor) is uploaded as: a float
    image keeps its own (None), any other becomes float32."""
    floating = data.is_floating_point() if torch.is_tensor(data) else \
        np.asarray(data).dtype.kind == "f"
    return None if floating else torch.float32


def _source(data, dtype):
    """``data`` as a tensor (an array's memory shared) and the bytes its
    upload as ``dtype`` takes from the host (0 from a device), counted as
    ``upload.bytes``."""
    t = data if torch.is_tensor(data) else torch.as_tensor(np.asarray(data))
    nbytes = t.numel() * (dtype or t.dtype).itemsize \
        if t.device.type == "cpu" else 0
    trace.count("upload.bytes", nbytes)
    return t, nbytes


def _staged(t: torch.Tensor, device: torch.device) -> bool:
    return device.type == "cuda" and t.device.type == "cpu"


def _begin(t: torch.Tensor, device, dtype):
    """The destination, allocated on the caller's current stream, and the
    event recorded there after the allocation."""
    dst = torch.empty(t.shape, dtype=dtype or t.dtype, device=device)
    after = torch.cuda.Event()
    after.record(torch.cuda.current_stream(dst.device))
    return dst, after


def _dma(stream):
    def send(d, b):
        with torch.cuda.stream(stream):
            d.copy_(b, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev
    return send


def _fill(t: torch.Tensor, dst: torch.Tensor, after):
    """Copy the host tensor ``t`` into the CUDA tensor ``dst`` through the
    ring, on the copy stream of ``dst``'s device once ``after`` has
    passed; returns the event of the last copy."""
    stream = _copy_stream(dst.device)
    stream.wait_event(after)
    try:
        ring().copy(t, dst, _dma(stream))
    except BaseException:
        stream.synchronize()        # no copy into dst outlives this call
        raise
    done = torch.cuda.Event()
    done.record(stream)
    return done


def _plain(t: torch.Tensor, device, dtype):
    return t.to(device=device, dtype=dtype).contiguous()


def upload(data, device, dtype=None) -> torch.Tensor:
    """``data`` (an array or a tensor) on ``device`` as ``dtype`` (its own
    type when None), contiguous, inside the span ``sift3d.upload``: staged
    through the ring when it goes from the host to a CUDA device (the
    caller's stream is ordered after the copy), else the plain ``.to()``.
    Where ``data`` is the Pending of ``upload_start``, the span holds the
    caller's wait for that copy (``device`` and ``dtype`` are then the
    Pending's own)."""
    with record_function("sift3d.upload"):
        if isinstance(data, Pending):
            return data.result()
        t, _ = _source(data, dtype)
        device = torch.device(device)
        if not _staged(t, device):
            return _plain(t, device, dtype)
        dst, after = _begin(t, device, dtype)
        done = _fill(t, dst, after)
        torch.cuda.current_stream(dst.device).wait_event(done)
        return dst


class Pending:
    """An upload running on the upload worker. ``result()`` waits for it
    (raising the worker's exception) and orders the caller's current
    stream after its copies; ``wait()`` does the same and raises
    nothing. ``nbytes``: what it takes from the host."""

    def __init__(self, future, dst, nbytes: int):
        self._future = future
        self._dst = dst
        self.nbytes = nbytes

    def result(self) -> torch.Tensor:
        out = self._future.result()
        if self._dst is None:
            return out
        torch.cuda.current_stream(self._dst.device).wait_event(out)
        return self._dst

    def wait(self) -> None:
        concurrent.futures.wait([self._future])
        if self._future.exception() is None:
            self.result()


def upload_start(data, device, dtype=None) -> Pending:
    """Start ``upload``'s copy on the upload worker and return at once,
    with no span: the worker opens none, so no device work that the
    caller launches meanwhile is given to it. Hand the Pending to
    ``upload`` where the tensor is needed, and ``wait()`` on it before
    the data it reads can go."""
    t, nbytes = _source(data, dtype)
    device = torch.device(device)
    if not _staged(t, device):
        return Pending(_worker().submit(_plain, t, device, dtype), None,
                       nbytes)
    dst, after = _begin(t, device, dtype)
    return Pending(_worker().submit(_fill, t, dst, after), dst, nbytes)
