"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy inputs go through the JAX package and the port; these
helpers carry JAX results across to the port through
``sift3d_tpu_torch.convert``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from sift3d_tpu_torch import convert
from sift3d_tpu_torch.features import detect as detect_mod
from sift3d_tpu_torch.ops import upload

KP_FIELDS = ("x", "y", "z", "o", "s", "sd", "R")


def jax_keypoints_to_port(kp, device="cpu"):
    """A port Keypoints set holding the JAX Keypoints' rows (batched for a
    batched JAX set)."""
    return convert.keypoints_from_numpy(
        **{f: np.asarray(getattr(kp, f)) for f in KP_FIELDS},
        count=np.asarray(kp.count), device=device)


def jax_descriptors_to_port(desc, pad=None, device="cpu"):
    """A port Descriptors set holding the JAX set's rows (all of them, or
    the valid rows and ``pad`` padding rows)."""
    n = None if pad is None else int(desc.count) + pad
    return convert.descriptors_from_numpy(
        np.asarray(desc.xyz)[:n], np.asarray(desc.sd)[:n],
        np.asarray(desc.vec)[:n], int(desc.count), device=device)


def port_params(jax_params):
    """The port's parameter object equal to a JAX parameter object."""
    import sift3d_tpu_torch.config as pcfg
    return convert.params_from_dict(getattr(pcfg, type(jax_params).__name__),
                                    dataclasses.asdict(jax_params))


def keypoint_rows(kp) -> np.ndarray:
    """(count, 7) rows [x y z o s sd] plus the flattened R (9 cols), for
    JAX or port keypoints."""
    n = int(kp.count)
    cols = []
    for f in ("x", "y", "z", "o", "s", "sd"):
        a = getattr(kp, f)
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        cols.append(a[:n].astype(np.float64)[:, None])
    R = kp.R
    R = R.cpu().numpy() if torch.is_tensor(R) else np.asarray(R)
    return np.concatenate(cols + [R[:n].reshape(n, 9).astype(np.float64)], 1)


@contextlib.contextmanager
def _cpu_parts(data, device, dtype=None):
    """``upload.upload_parts`` on the CPU, cut by ``upload.sub_batches`` as
    a stack that streams to a card is."""
    x = upload.upload(data, device, dtype)
    yield x.shape[0], ((sl, x[sl]) for sl in
                       upload.sub_batches(x.shape, x.element_size()))


@contextlib.contextmanager
def sub_batched(sub_batch_bytes: int):
    """``features.detect.detect`` builds each stack's pyramid sub-batch by
    sub-batch on the CPU (where nothing streams), each sub-batch the
    fewest volumes reaching ``sub_batch_bytes``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(upload, "SUB_BATCH_BYTES", sub_batch_bytes)
        mp.setattr(detect_mod, "upload_parts", _cpu_parts)
        yield
