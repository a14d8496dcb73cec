"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy inputs go through the JAX package and the port; these
helpers carry JAX results across to the port through
``sift3d_tpu_torch.convert``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sift3d_tpu_torch import convert

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
