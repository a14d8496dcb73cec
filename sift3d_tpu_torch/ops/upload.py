"""Every copy of the pipeline's input volumes to a device: ``upload`` and
``upload_start`` take an array or a tensor, count the bytes it takes from
the host (``upload.bytes``) and open the ``sift3d.upload`` span (see
``utils/trace``); ``image_dtype`` is the API's rule for the type an image
is uploaded as.

A pageable ``.to(device)`` of a volume stack holds the caller for the
whole copy, and the card has nothing to do meanwhile. Here a copy from
the host (a CPU tensor) to a CUDA device is staged through pinned
buffers and queued on a copy stream of its own, so that staging the next
piece overlaps the device copy of this one. A contiguous source that
keeps its type goes through ``csrc/host_stage.cu`` (``_native_copy``):
``STAGE_THREADS`` host threads copy its ``STAGE_CHUNK_BYTES`` pieces
into pinned buffers of their own and queue each piece's device copy,
the whole loop in one native call that runs without the interpreter's
lock, so a caller launching work on another thread does not slow it.
Any other source (a change of type, e.g. int16 to float32, or a strided
view) goes through a process-wide ring of ``RING_DEPTH`` pinned buffers
of ``CHUNK_BYTES`` (``Ring``), allocated on first use and reused by
every later call: the source is cut into contiguous pieces of at most a
buffer each (``pieces``); for each piece the host waits for the last
copy out of its buffer, copies the piece in with torch's CPU copy
(which converts the type) and queues the buffer's copy to the device.
Nothing is kept of the caller's data: every call copies every byte.
Every other copy (to a CPU destination, or of a tensor already on a
device) is the plain ``.to()``, made contiguous.

Stream safety: the destination is allocated on the caller's thread, on
its current stream; the copy stream first waits for an event recorded
there after the allocation, and the caller's stream waits for the
upload's last event before any use. No ``record_stream``, and no host
sync of the caller's stream.

``upload_start`` runs an upload on the one upload worker thread and
returns at once with a ``Pending``: uploads run there in the order they
were started, so a caller can start the upload of the next batch before
it works on this one.

``upload_parts`` hands a stack of volumes over in the sub-batches that
land one after another, so that the caller works on each while the next
goes up. A stack streams where the source is on the host, the device is
CUDA and the stack holds at least two sub-batches (``sub_batches``): its
upload runs on the worker, one sub-batch after another, each with an
event of its own that the caller's stream waits on. Any
other source is the one ``upload`` it was. The bytes that land after the
first sub-batch are counted as ``upload.streamed_bytes``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import itertools
import math
import threading

import numpy as np
import torch
from torch.profiler import record_function

from .. import _build
from ..utils import trace

CHUNK_BYTES = 64 << 20      # one ring buffer
RING_DEPTH = 4              # buffers in the ring
# The native staging (``_native_copy``): host threads, the caller's
# among them, and the bytes each copies into a pinned buffer at a time.
# Set on an NVIDIA H100 80GB HBM3 at 700 W with 8 host cores (PERF.md
# section 6): a 1.85 GB stack staged at 12.2-25.5 GB/s alone and 10.8-17.5
# GB/s beside a caller launching pyramids at 4-8 threads (the torch ring
# 5.2-5.4); in portbench's mni152.batch64, 4 threads read 185.96 and
# 171.30 pairs/s against 7's 160.14 and 177.42 on one machine, and 4, 6
# and 7 threads 188.24-196.83 pairs/s on another, where the card sets
# the pace. The piece size was compared at 7 threads only, in the probe:
# 4 MiB staged 18.97-26.10 GB/s alone and 13.52-15.36 beside pyramids,
# 8 MiB 13.12-19.86 and 12.79-13.44, 16 MiB 11.20-20.69 and 9.83-11.52.
# 8 MiB is what the cell ran at 4 threads; 4 MiB there is not measured
# (PERF.md section 7).
STAGE_THREADS = 4
STAGE_CHUNK_BYTES = 8 << 20
# Bytes a streamed sub-batch reaches (``sub_batches``): 10 volumes of
# the MNI152 1 mm grid, 7 sub-batches of a 64-volume stack. Swept on an
# NVIDIA H100 80GB HBM3 at 700 W by portbench's mni152.batch64 on three
# machines while the torch ring still did the staging, in turns with the
# port before streaming (PERF.md section 6 has every run): 256 MiB read
# 116.72-186.92 pairs/s and led in each of 7 turns (72.64-138.56 before);
# 512 MiB read 122.55-167.26 and peaked 0.8 GB higher (28.64e9 B against
# 27.86e9); 1 GiB 101.88-117.00 and 128 MiB 73.04-116.95 on the slowest
# host. With the native staging the cell read 170.17-193.16 pairs/s at
# 256 MiB; the sweep is not yet repeated there (PERF.md section 7).
SUB_BATCH_BYTES = 256 << 20

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


def sub_batches(shape, itemsize: int) -> list:
    """Slices of the first axis of a (B, nz, ny, nx) stack of ``shape``:
    each the fewest whole volumes whose bytes reach ``SUB_BATCH_BYTES``,
    the last the volumes left."""
    per = max(-(-SUB_BATCH_BYTES // (math.prod(shape[1:]) * itemsize)), 1)
    return [slice(a, min(a + per, shape[0]))
            for a in range(0, shape[0], per)]


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


def _native_copy(src: torch.Tensor, dst: torch.Tensor, stream) -> None:
    """Queue the copy of the contiguous host tensor ``src`` into the
    contiguous CUDA tensor ``dst`` of its shape and type on ``stream``,
    staged by ``csrc/host_stage.cu``; returns once every piece is queued
    (ctypes lets go of the interpreter's lock for the call)."""
    fn = _build.load("host_stage").sift3d_stage_copy
    if fn.argtypes is None:
        P, S, I = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
        fn.argtypes = [P, P, S, S, I, I, P]
        fn.restype = I
    _build.check(fn(src.data_ptr(), dst.data_ptr(),
                    src.numel() * src.element_size(), STAGE_CHUNK_BYTES,
                    STAGE_THREADS, dst.device.index, stream.cuda_stream),
                 "sift3d_stage_copy")


def _fill(t: torch.Tensor, dst: torch.Tensor, after, parts=None):
    """Copy the host tensor ``t`` into the CUDA tensor ``dst`` (natively
    staged, or through the ring), on the copy stream of ``dst``'s device
    once ``after`` has passed; returns the event of the last copy. ``parts``: (slice,
    future) of each sub-batch of a streamed stack, copied in turn, each
    future given the event of its sub-batch's last copy."""
    stream = _copy_stream(dst.device)
    stream.wait_event(after)
    try:
        for sl, landed in parts or [(slice(None), None)]:
            src, to = t[sl], dst[sl]
            if src.is_contiguous() and src.dtype == to.dtype:
                _native_copy(src, to, stream)
            else:
                ring().copy(src, to, _dma(stream))
            if landed is not None:
                ev = torch.cuda.Event()
                ev.record(stream)
                landed.set_result(ev)
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
    nothing. ``nbytes``: what it takes from the host; ``shape``: the
    tensor's. A streamed stack's sub-batches can be taken as they land
    (``upload_parts``)."""

    def __init__(self, future, dst, nbytes: int, shape, parts=None):
        self._future = future
        self._dst = dst
        self.nbytes = nbytes
        self.shape = tuple(shape)
        self._parts = parts

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

    def _landed(self):
        """Each sub-batch as (slice, tensor) once its copy is queued: the
        caller waits for it in the span ``sift3d.upload``, where its
        current stream is ordered after the copy."""
        for k, (sl, landed) in enumerate(self._parts):
            with record_function("sift3d.upload"):
                concurrent.futures.wait(
                    [landed, self._future],
                    return_when=concurrent.futures.FIRST_COMPLETED)
                if not landed.done():
                    self._future.result()   # raises the worker's error
                torch.cuda.current_stream(self._dst.device).wait_event(
                    landed.result())
            part = self._dst[sl]
            if k:
                trace.count("upload.streamed_bytes",
                            part.numel() * part.element_size())
            yield sl, part


def _stream_parts(t: torch.Tensor, device, dtype):
    """The sub-batches a stack streams in: a host stack of volumes bound
    for a CUDA device that holds at least two; else None."""
    if not _staged(t, device) or t.ndim != 4:
        return None
    parts = sub_batches(t.shape, (dtype or t.dtype).itemsize)
    return parts if len(parts) > 1 else None


def upload_start(data, device, dtype=None) -> Pending:
    """Start ``upload``'s copy on the upload worker and return at once,
    with no span: the worker opens none, so no device work that the
    caller launches meanwhile is given to it. Hand the Pending to
    ``upload`` or ``upload_parts`` where the tensor is needed, and
    ``wait()`` on it before the data it reads can go."""
    t, nbytes = _source(data, dtype)
    device = torch.device(device)
    if not _staged(t, device):
        return Pending(_worker().submit(_plain, t, device, dtype), None,
                       nbytes, t.shape)
    dst, after = _begin(t, device, dtype)
    parts = _stream_parts(t, device, dtype)
    if parts is not None:
        parts = [(sl, concurrent.futures.Future()) for sl in parts]
    return Pending(_worker().submit(_fill, t, dst, after, parts), dst,
                   nbytes, t.shape, parts)


@contextlib.contextmanager
def upload_parts(data, device, dtype=None):
    """``upload`` of a (B, nz, ny, nx) stack (an array, a tensor or the
    Pending of ``upload_start``) in the sub-batches that land one after
    another. Yields (B, parts): ``parts`` iterates over (slice of the
    batch axis, those volumes on ``device``), each once the caller's
    stream is ordered after its copy. A stack that streams (see the
    module's docstring) goes up on the upload worker, and the caller
    waits for each sub-batch in its own ``sift3d.upload`` span; any other
    is one part, ``upload``'s tensor. The block does not end while the
    worker reads ``data``."""
    if not isinstance(data, Pending):
        t = data if torch.is_tensor(data) else \
            torch.as_tensor(np.asarray(data))
        if _stream_parts(t, torch.device(device), dtype):
            data = upload_start(t, device, dtype)
    if not isinstance(data, Pending) or data._parts is None:
        trace.count("upload.streamed_bytes", 0)
        x = upload(data, device, dtype)
        yield x.shape[0], iter([(slice(0, x.shape[0]), x)])
        return
    try:
        yield data.shape[0], data._landed()
    finally:
        data.wait()
