"""A stack's pyramid built sub-batch by sub-batch (``pyramid.build_into``,
``features/detect.detect`` over ``ops/upload.upload_parts``) and the rule
that decides when a stack streams (``upload.sub_batches``,
``upload._stream_parts``).

On the CPU nothing streams, so the detection cases stand in a CPU twin
of ``upload_parts`` that cuts the stack by the same ``sub_batches``
(``tests/torch_helpers.sub_batched``), with ``SUB_BATCH_BYTES`` a few
volumes: B = 4 volumes of 40^3 built in 4 or 2
uneven sub-batches equal the whole-batch build (levels and DoG within
1e-6 of each level's largest value; keypoint rows per volume exact). The
streamed path on the card is ``tests/test_torch_upload.py``'s card test.
"""

import numpy as np
import pytest
import torch

from benches.data import make_pairs
from sift3d_tpu_torch import pyramid as tpyr
from sift3d_tpu_torch.config import SIFT3DParams
from sift3d_tpu_torch.convert import volume
from sift3d_tpu_torch.ops import upload
from sift3d_tpu_torch.parallel import pipeline as tpipe
from tests.torch_helpers import keypoint_rows, sub_batched

torch.set_num_threads(1)

SHAPE = (40, 40, 40)
VOL_BYTES = 4 * 40 ** 3
# Volumes a sub-batch -> the sub-batches of a 4-volume stack.
SPLITS = {1: [(0, 1), (1, 2), (2, 3), (3, 4)], 3: [(0, 3), (3, 4)]}


@pytest.fixture(scope="module")
def stack():
    src, ref = make_pairs(2, SHAPE, nblob=60)
    params = SIFT3DParams()
    plan = tpyr.plan_pyramid(SHAPE[::-1], (1.0, 1.0, 1.0), params)
    return np.concatenate([src, ref]), plan, params


@pytest.fixture(params=sorted(SPLITS), ids=lambda k: f"{k}vol")
def streamed(request):
    """``detect`` cutting stacks into sub-batches of ``k`` volumes."""
    with sub_batched(request.param * VOL_BYTES):
        yield request.param


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        scale = float(want[key].abs().max())
        torch.testing.assert_close(got[key], want[key], rtol=0,
                                   atol=1e-6 * scale, msg=str(key))


def test_sub_batches_rule(monkeypatch):
    monkeypatch.setattr(upload, "SUB_BATCH_BYTES", 3 * VOL_BYTES)
    stack4 = (4,) + SHAPE
    assert [(s.start, s.stop) for s in upload.sub_batches(stack4, 4)] == \
        SPLITS[3]
    # Bytes just past 2 volumes take 3; int16 volumes are half the bytes.
    monkeypatch.setattr(upload, "SUB_BATCH_BYTES", 2 * VOL_BYTES + 1)
    assert [s.stop - s.start for s in upload.sub_batches(stack4, 4)] == \
        [3, 1]
    assert [s.stop - s.start for s in upload.sub_batches(stack4, 2)] == [4]
    # A volume larger than the constant is a sub-batch alone.
    monkeypatch.setattr(upload, "SUB_BATCH_BYTES", 1)
    assert len(upload.sub_batches(stack4, 4)) == 4
    # Streams: a host stack of at least two sub-batches bound for CUDA.
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    host = torch.zeros(stack4)
    assert len(upload._stream_parts(host, cuda, torch.float32)) == 4
    assert upload._stream_parts(host, cpu, torch.float32) is None
    assert upload._stream_parts(host[0], cuda, torch.float32) is None
    assert upload._stream_parts(host[:1], cuda, torch.float32) is None
    monkeypatch.setattr(upload, "SUB_BATCH_BYTES", 4 * VOL_BYTES)
    assert upload._stream_parts(host, cuda, torch.float32) is None


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["build_gpyr", "pipelined"])
def test_levels_equal_whole_batch(stack, streamed, pipelined):
    vols, plan, _ = stack
    x = torch.as_tensor(vols)
    build = tpyr.build_gpyr_pipelined if pipelined else tpyr.build_gpyr
    want = build(tpyr.im_scale(x), plan)
    want_dog = tpyr.build_dog(want, plan)
    gpyr, dog = {}, {}
    slices = upload.sub_batches(x.shape, x.element_size())
    assert [(s.start, s.stop) for s in slices] == SPLITS[streamed]
    for sl in slices:
        tpyr.build_into(gpyr, dog, x[sl], sl, x.shape[0], plan, pipelined)
    _close(gpyr, want)
    _close(dog, want_dog)


def test_keypoint_rows_exact_against_whole_batch(stack, streamed):
    vols, plan, params = stack
    whole = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(upload, "SUB_BATCH_BYTES", 1 << 40)
        whole["kp"], _, whole["ov"] = tpipe.batch_detect_describe(
            vols, plan, params, device="cpu")
    kp, _, ov = tpipe.batch_detect_describe(vols, plan, params, device="cpu")
    assert kp.count.tolist() == whole["kp"].count.tolist()
    assert ov.tolist() == whole["ov"].tolist()
    for b in range(vols.shape[0]):
        want = keypoint_rows(volume(whole["kp"], b))
        got = keypoint_rows(volume(kp, b))
        assert want.shape[0] >= 10, "too few keypoints to be a real test"
        np.testing.assert_array_equal(got[:, :6], want[:, :6])
        np.testing.assert_allclose(got[:, 6:], want[:, 6:], rtol=0,
                                   atol=1e-5)
