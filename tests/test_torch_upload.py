"""The staged volume upload (``sift3d_tpu_torch/ops/upload.py``) and the
ref-ahead upload of ``batch_register_pairs``.

On the CPU the ring's chunk loop runs with unpinned buffers, a small
``CHUNK_BYTES`` and a host copy in place of the copy to the card: each
result is bitwise ``torch.as_tensor(x).to(dtype)``, the ring is made once
and reused, a thread stress loses no piece, an exception on the upload
worker reaches the caller (and only after the worker has let go of the
caller's arrays), and the ``upload.*`` counters count the same with the
profiler on and off. The card tests (skipped without a CUDA device; on
the card run ``python -m pytest --noconftest tests/test_torch_upload.py
-q``, this file needs no JAX) hold ``batch_register_pairs`` on numpy
stacks (staged, ref-ahead; and streamed in sub-batches) to the same call
on stacks already on the card.
"""

import dataclasses
import math
import sys
import threading
import time

import numpy as np
import pytest
import torch

from benches.data import make_pairs
from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.api import RegSift3D
from sift3d_tpu_torch.config import RansacParams, SIFT3DParams
from sift3d_tpu_torch.ops import upload
from sift3d_tpu_torch.parallel.pipeline import batch_register_pairs
from sift3d_tpu_torch.utils import trace

torch.set_num_threads(1)

SHAPE = (24, 24, 24)
CHUNK = 4096


class _Fence:
    """The fence of one host copy out of a buffer: counts its waits."""
    waits = 0

    def synchronize(self):
        _Fence.waits += 1


def _host_send(d, b):
    time.sleep(0)       # other threads run first, as during a copy to a card
    d.copy_(b)
    return _Fence()


@pytest.fixture()
def small_ring(monkeypatch):
    """A fresh process-wide ring of ``CHUNK``-byte buffers."""
    monkeypatch.setattr(upload, "CHUNK_BYTES", CHUNK)
    monkeypatch.setattr(upload, "_ring_obj", None)
    _Fence.waits = 0


def _staged(x, dtype=torch.float32) -> torch.Tensor:
    t = torch.as_tensor(x) if not torch.is_tensor(x) else x
    dst = torch.empty(t.shape, dtype=dtype)
    upload.ring().copy(t, dst, _host_send)
    return dst


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        raw(a), raw(b))


def _rng():
    return np.random.default_rng(20261018)


def _equal_to_plain(x, dtype=torch.float32):
    out = _staged(x, dtype)
    assert _bitwise(out, torch.as_tensor(x).to(dtype))
    return out


def case_float32():
    # 7680-byte volumes: two pieces each, six in all, so the ring wraps.
    x = _rng().standard_normal((3, 16, 12, 10)).astype(np.float32)
    _equal_to_plain(x)
    assert _Fence.waits == 2


def case_int16_to_float32():
    x = _rng().integers(-32768, 32767, (3, 16, 12, 10), dtype=np.int16)
    _equal_to_plain(x)


def case_non_contiguous_view():
    base = torch.as_tensor(
        _rng().standard_normal((4, 20, 12, 10)).astype(np.float32))
    view = base[::2, 1::2].transpose(2, 3)
    assert not view.is_contiguous()
    _equal_to_plain(view)


def case_not_a_chunk_multiple():
    # 37 planes of 396 bytes a volume: pieces of 10, 10, 10 and 7 planes.
    x = _rng().standard_normal((2, 37, 9, 11)).astype(np.float32)
    assert x.nbytes % CHUNK
    _equal_to_plain(x)
    assert [p[1].stop - p[1].start for p in
            upload.pieces(x.shape, 4, CHUNK)] == [10, 10, 10, 7] * 2


def case_batch_of_one():
    x = _rng().standard_normal((1, 16, 12, 10)).astype(np.float32)
    _equal_to_plain(x)


def case_ring_reused():
    x = _rng().standard_normal((3, 16, 12, 10)).astype(np.float32)
    r = upload.ring()
    ptrs = [b.data_ptr() for b in r.bufs]
    for k in range(3):
        _equal_to_plain(x * (k + 1))
    assert upload.ring() is r
    assert [b.data_ptr() for b in r.bufs] == ptrs
    assert len(r.bufs) == upload.RING_DEPTH
    assert all(b.numel() == CHUNK for b in r.bufs)
    # Each call waits on the fences the one before left.
    assert _Fence.waits == 3 * 6 - upload.RING_DEPTH


def case_threads_lose_nothing():
    """More threads than cores share the ring and the worker; a piece
    staged by one and overwritten by another before its copy would break
    the equality."""
    errors = []

    def work(seed):
        try:
            rng = np.random.default_rng(seed)
            for _ in range(4):
                x = rng.standard_normal((2, 16, 12, 10)).astype(np.float32)
                _equal_to_plain(x)
                got = upload.upload_start(x, "cpu", torch.float64).result()
                assert torch.equal(got, torch.as_tensor(x).double())
        except Exception as e:          # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def _pairs():
    src, ref = make_pairs(2, SHAPE, nblob=40)
    params = SIFT3DParams()
    plan = tpyr.plan_pyramid(SHAPE[::-1], (1.0, 1.0, 1.0), params)
    return src, ref, plan, params


def _register(src, ref, plan, params, device="cpu"):
    return batch_register_pairs(src, ref, plan, params,
                                ransac_params=RansacParams(num_iter=50),
                                device=device)


def _plain_failing(side: int, released: threading.Event):
    """``upload._plain`` that raises on the upload of ``side`` (1 src, 2
    ref) and lets go of the ref stack only after 0.2 s."""
    calls = []

    def plain(t, device, dtype):
        calls.append(t)
        if len(calls) == 2:
            time.sleep(0.2)
            released.set()
        if len(calls) == side:
            raise ValueError(f"upload {side} failed")
        return t.to(device=device, dtype=dtype)
    return plain


def case_worker_raises():
    src, ref, plan, params = _pairs()
    for side in (1, 2):
        released = threading.Event()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(upload, "_plain", _plain_failing(side, released))
            with pytest.raises(ValueError, match=f"upload {side} failed"):
                _register(src, ref, plan, params)
        # The call ended only once the worker was done with the ref stack.
        assert released.is_set()


def _delta(fn) -> dict:
    before = trace.counters()
    fn()
    after = trace.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith("upload.") and v != before.get(k, 0)}


def case_counts_with_and_without_profiler():
    src, ref, plan, params = _pairs()
    x16 = _rng().integers(-100, 100, (2, 6, 5, 4), dtype=np.int16)

    def calls():
        _register(src, ref, plan, params)
        upload.upload(x16, "cpu", torch.float32)
        upload.upload_start(x16, "cpu").result()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _delta(calls)
    untraced = _delta(calls)
    assert traced == untraced
    assert traced["upload.bytes"] == 2 * src.nbytes + x16.size * (4 + 2)
    assert traced["upload.ahead_bytes"] == ref.nbytes == src.nbytes


CASES = {f.__name__[len("case_"):]: f for f in (
    case_float32, case_int16_to_float32, case_non_contiguous_view,
    case_not_a_chunk_multiple, case_batch_of_one, case_ring_reused,
    case_threads_lose_nothing, case_worker_raises,
    case_counts_with_and_without_profiler)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_upload(case, small_ring):
    CASES[case]()


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staged upload and its copy "
                    "stream run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_staged_upload_card(cuda):
    """4 pairs of 64^3 blob volumes: numpy stacks (staged through the
    pinned ring, ref ahead) against the same stacks already on the card
    (the plain path), bit for bit; the ahead bytes are half the bytes
    uploaded. The same for ``RegSift3D.register`` on one pair. Then a
    multi-chunk int16 stack and a non-contiguous view
    through ``upload`` against the plain ``.to()``."""
    shape = (64, 64, 64)
    src, ref = make_pairs(4, shape)
    params = SIFT3DParams()
    plan = tpyr.plan_pyramid(shape[::-1], (1.0, 1.0, 1.0), params)
    got = {}
    staged_counts = _delta(lambda: got.setdefault(
        "staged", batch_register_pairs(src, ref, plan, params,
                                       device=cuda)))
    plain_counts = _delta(lambda: got.setdefault(
        "plain", batch_register_pairs(torch.as_tensor(src, device=cuda),
                                      torch.as_tensor(ref, device=cuda),
                                      plan, params, device=cuda)))
    for f in dataclasses.fields(got["plain"]):
        a, b = getattr(got["staged"], f.name), getattr(got["plain"], f.name)
        assert _bitwise(a, b), f.name
    assert staged_counts["upload.bytes"] == 2 * src.nbytes
    assert 2 * staged_counts["upload.ahead_bytes"] == \
        staged_counts["upload.bytes"]
    assert plain_counts == {}

    # The single-pair API stages each volume on the caller's thread.
    reg = RegSift3D(device=cuda)
    staged = reg.register(src[0], ref[0])
    plain = reg.register(torch.as_tensor(src[0], device=cuda),
                         torch.as_tensor(ref[0], device=cuda))
    for f in dataclasses.fields(plain):
        assert np.array_equal(getattr(staged, f.name),
                              getattr(plain, f.name)), f.name

    rng = _rng()
    x16 = rng.integers(-32768, 32767, (9, 182, 218, 182), dtype=np.int16)
    out = upload.upload(torch.as_tensor(x16), cuda, torch.float32)
    assert out.is_cuda
    assert _bitwise(out, torch.as_tensor(x16).to(cuda, torch.float32))
    base = torch.as_tensor(rng.standard_normal(
        (6, 100, 90, 80)).astype(np.float32))
    view = base[::2, :, 5:].transpose(1, 3)
    out = upload.upload(view, cuda)
    assert _bitwise(out, view.to(cuda).contiguous())
    torch.cuda.synchronize()


@pytest.mark.parametrize("chunk,threads", [(8 << 20, 7), (1 << 20, 3),
                                           (4096, 1)])
def test_native_staging_card(cuda, monkeypatch, chunk, threads):
    """Contiguous host sources that keep their type go through
    ``csrc/host_stage.cu``: a stack of several pieces a thread, one piece
    shorter than the rest, a slice at an offset and a single byte-odd
    volume, each bit for bit the plain ``.to()``, on the caller's thread
    and on the worker; the ring takes none of them. Changing the
    chunk or the threads remakes the staging buffers between calls."""
    monkeypatch.setattr(upload, "STAGE_CHUNK_BYTES", chunk)
    monkeypatch.setattr(upload, "STAGE_THREADS", threads)
    native = []
    real = upload._native_copy
    monkeypatch.setattr(upload, "_native_copy", lambda s, d, st: (
        native.append(s.numel() * s.element_size()), real(s, d, st)))
    monkeypatch.setattr(upload.Ring, "copy", None)   # not called
    rng = _rng()
    stack = torch.as_tensor(rng.standard_normal(
        (5, 61, 67, 71)).astype(np.float32))
    cases = [stack, stack[2:4], torch.as_tensor(
        rng.integers(0, 255, (1, 3, 5, 7), dtype=np.uint8))]
    for x in cases:
        assert _bitwise(upload.upload(x, cuda), x.to(cuda))
        assert _bitwise(upload.upload_start(x, cuda).result(), x.to(cuda))
    assert native == [x.numel() * x.element_size()
                      for x in cases for _ in range(2)]
    torch.cuda.synchronize()


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["build_gpyr", "pipelined"])
def test_streamed_upload_card(cuda, monkeypatch, pipelined):
    """8 pairs of 64^3 blob volumes from numpy stacks, each side streamed
    in 4 sub-batches of 2 volumes (its pyramid built as each lands, by
    either builder), against the same stacks already on the card: matches
    exact, the affine within 1e-6; the bytes after each side's first
    sub-batch are counted as streamed, and a streamed call once the blur
    operators are on the card copies none up. One volume
    (``RegSift3D.register``) streams nothing."""
    shape = (64, 64, 64)
    vol_bytes = 4 * math.prod(shape)
    monkeypatch.setattr(upload, "SUB_BATCH_BYTES", 2 * vol_bytes)
    src, ref = make_pairs(8, shape)
    params = SIFT3DParams()
    plan = tpyr.plan_pyramid(shape[::-1], (1.0, 1.0, 1.0), params)
    got = {}
    counts = _delta(lambda: got.setdefault(
        "streamed", batch_register_pairs(src, ref, plan, params,
                                         device=cuda, pipelined=pipelined)))
    plain = batch_register_pairs(torch.as_tensor(src, device=cuda),
                                 torch.as_tensor(ref, device=cuda),
                                 plan, params, device=cuda,
                                 pipelined=pipelined)
    streamed = got["streamed"]
    assert int(plain.num_matches.min()) >= 10
    for f in ("matches", "match_src", "match_ref", "num_matches",
              "num_inliers", "ok", "inlier_mask", "kp_overflow"):
        assert torch.equal(getattr(streamed, f), getattr(plain, f)), f
    torch.testing.assert_close(streamed.A, plain.A, rtol=0, atol=1e-6)
    assert counts["upload.bytes"] == 2 * src.nbytes
    assert counts["upload.ahead_bytes"] == src.nbytes
    assert counts["upload.streamed_bytes"] == 2 * 6 * vol_bytes
    w_uploads = trace.counters().get("conv.w_uploads", 0)
    again = _delta(lambda: batch_register_pairs(
        src, ref, plan, params, device=cuda, pipelined=pipelined))
    assert again["upload.streamed_bytes"] == 2 * 6 * vol_bytes
    assert trace.counters().get("conv.w_uploads", 0) == w_uploads

    one = _delta(lambda: RegSift3D(device=cuda).register(src[0], ref[0]))
    assert one["upload.bytes"] == 2 * vol_bytes
    assert "upload.streamed_bytes" not in one
    torch.cuda.synchronize()
