"""The frozen work counts and the trace arithmetic."""

import numpy as np
import pytest

from portbench import trace_read
from portbench.reference.config import SIFT3DParams
from portbench.reference.pyramid import plan_pyramid
from portbench.work import peaks
from portbench.work.descrip import descrip_work
from portbench.work.pyramid import pyramid_work


def test_pyramid_count_by_hand():
    # 16^3: two octaves, Gaussian levels s = -1..4, DoG levels s = -1..3.
    # Taps (2 ceil(3 sigma) + 1): the first blur sigma 0.5387 -> 5; the
    # incremental blurs to s = 0..4, sigma 0.9733, 1.2263, 1.5450, 1.9466,
    # 2.4525 -> 7, 9, 11, 13, 17 (57 together).
    plan = plan_pyramid((16, 16, 16), (1.0, 1.0, 1.0), SIFT3DParams())
    flops = (3 * 2 * (57 + 5) * 16 ** 3 + 5 * 16 ** 3 +
             3 * 2 * 57 * 8 ** 3 + 5 * 8 ** 3)
    nbytes = 4 * (16 ** 3 + 11 * 16 ** 3 + 11 * 8 ** 3)
    assert flops == 1_721_856 and nbytes == 219_136
    assert pyramid_work(plan, 1) == (nbytes, flops)
    assert pyramid_work(plan, 3) == (3 * nbytes, 3 * flops)


@pytest.mark.parametrize("banded_min_n, frame_tile", [(1, 8), (10 ** 9, 128)])
def test_pyramid_count_ignores_the_conv_form(monkeypatch, banded_min_n,
                                            frame_tile):
    """The port's choice of dense or framed blur does not move the
    count."""
    from sift3d_tpu_torch.ops import conv
    plan = plan_pyramid((64, 48, 40), (1.0, 1.2, 0.9), SIFT3DParams())
    before = pyramid_work(plan, 2)
    monkeypatch.setattr(conv, "BANDED_MIN_N", banded_min_n)
    monkeypatch.setattr(conv, "FRAME_TILE", frame_tile)
    assert pyramid_work(plan, 2) == before


def test_descrip_count_repeats_and_is_positive():
    from portbench import volumes
    vols = volumes.blob_volumes(2, (32, 32, 32), 30,
                                volumes.generator(4, "cpu"), "cpu")
    params = SIFT3DParams()
    plan = plan_pyramid((32, 32, 32), (1.0, 1.0, 1.0), params)
    a = descrip_work(vols, plan, params, "cpu")
    assert a == descrip_work(vols, plan, params, "cpu")
    assert a[0] > 0 and a[1] > 0


def test_bound_takes_the_larger():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


def _ev(name, cat, ts, dur, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_summary():
    ev = [
        _ev("portbench.request", "user_annotation", 0, 100),
        _ev("sift3d.pyramid", "user_annotation", 10, 30),
        _ev("sift3d.extrema", "user_annotation", 50, 20),
        _ev("cudaLaunchKernel", "cuda_runtime", 12, 1, 1),
        _ev("cudaLaunchKernel", "cuda_runtime", 55, 1, 2),
        _ev("cudaMemcpyAsync", "cuda_runtime", 80, 1, 3),
        _ev("cudaMemcpyAsync", "cuda_runtime", 11, 1, 4),
        # launched in the pyramid span, run later on the device
        _ev("conv_kernel", "kernel", 20, 40, 1),
        _ev("cmp_kernel", "kernel", 60, 5, 2),
        _ev("Memcpy DtoH", "gpu_memcpy", 85, 5, 3),
        # the upload, launched in the pyramid span: counted apart
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 12, 6, 4),
        _ev("aten::nonzero", "cpu_op", 66, 4),
    ]
    s = trace_read.summarize(ev)
    assert s["requests"] == 1 and s["wall_s"] == pytest.approx(100e-6)
    # [12, 18) + [20, 65) + [85, 90)
    assert s["busy_s"] == pytest.approx(56e-6)
    assert s["span_busy_ms"]["sift3d.pyramid"] == pytest.approx(0.040)
    assert s["upload_ms"] == pytest.approx(0.006)
    assert s["span_busy_ms"]["sift3d.extrema"] == pytest.approx(0.005)
    assert s["span_host_ms"]["sift3d.extrema"] == pytest.approx(0.020)
    assert s["outside_ms"] == pytest.approx(0.050)
    assert s["device_ops"][0] == ["conv_kernel", pytest.approx(40e-6)]
    # idle [0, 12) (middle before the pyramid span), [65, 85) and
    # [90, 100) in the request's alone, [18, 20) in the pyramid span
    assert s["idle_gaps"] == [["portbench.request", pytest.approx(42e-6)],
                              ["sift3d.pyramid", pytest.approx(2e-6)]]
    assert trace_read.busy_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert np.isfinite(s["wall_s"])
