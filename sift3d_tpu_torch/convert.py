"""Carry state across from the JAX package.

SIFT3D has no learned weights: its state is its parameters and the
intermediate keypoint and descriptor sets. These helpers rebuild them in
the port from plain Python and numpy values, so that the JAX package's
own keypoints can feed the port's descriptor stage, and its descriptors
the port's matcher:

    params_from_dict(SIFT3DParams, dataclasses.asdict(jax_params))
    keypoints_from_numpy(**{f: np.asarray(getattr(kp, f)) for f in FIELDS})

A batched set of the JAX package (a leading B axis on every field, a (B,)
count) carries across the same way and becomes a batched set of the port;
``volume`` takes one volume's rows out of a batched set of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import MatchParams, RansacParams, SIFT3DParams
from .dtypes import F64, resolve_device
from .features.descriptor import Descriptors
from .features.keypoints import Keypoints

_PARAM_TYPES = (SIFT3DParams, MatchParams, RansacParams)

# Fields of the JAX package that steer paths the port does not have, with
# their JAX defaults: the JAX single-program detect path
# (``fused_bucket_cap``). They are dropped when they hold the default and
# refused otherwise.
_JAX_ONLY = {SIFT3DParams: {"fused_bucket_cap": 512}}


def params_from_dict(cls, d: dict):
    """A port parameter object of type ``cls`` from
    ``dataclasses.asdict`` of the JAX package's object of the same name."""
    if cls not in _PARAM_TYPES:
        raise TypeError(f"not a parameter type of the port: {cls!r}")
    kw = dict(d)
    for name, default in _JAX_ONLY.get(cls, {}).items():
        if name in kw and kw.pop(name) != default:
            raise ValueError(f"{cls.__name__}.{name}={d[name]!r}: the port "
                             f"has no path that reads it (only {default!r})")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(kw) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    if kw.get("max_kp_per_octave") is not None:
        kw["max_kp_per_octave"] = tuple(int(c) for c in kw["max_kp_per_octave"])
    return cls(**kw)


def _converter(device):
    """``t(a, dtype)``: the array ``a`` as a tensor of ``dtype`` on
    ``device``."""
    dev = resolve_device(device)
    return lambda a, dtype: torch.as_tensor(np.array(a), device=dev).to(dtype)


def _count(count, device):
    """An int for one set, a (B,) tensor for a batched set."""
    c = np.asarray(count)
    return int(c) if c.ndim == 0 else torch.as_tensor(c.astype(np.int64),
                                                      device=device)


def keypoints_from_numpy(x, y, z, o, s, sd, R, count, device="cpu") -> Keypoints:
    """Keypoints from the JAX ``Keypoints`` fields as numpy arrays."""
    t = _converter(device)
    return Keypoints(x=t(x, F64), y=t(y, F64), z=t(z, F64),
                     o=t(o, torch.int32), s=t(s, torch.int32), sd=t(sd, F64),
                     R=t(R, torch.float32), count=_count(count, device))


def descriptors_from_numpy(xyz, sd, vec, count, device="cpu") -> Descriptors:
    """Descriptors from the JAX ``Descriptors`` fields as numpy arrays."""
    t = _converter(device)
    return Descriptors(xyz=t(xyz, F64), sd=t(sd, F64),
                       vec=t(vec, torch.float32), count=_count(count, device))


def volume(batch, b: int):
    """Volume ``b`` of a batched Keypoints or Descriptors set, as the set
    of one volume holding its ``count[b]`` rows."""
    n = int(batch.count[b])
    return type(batch)(**{f.name: getattr(batch, f.name)[b, :n]
                          for f in dataclasses.fields(batch)
                          if f.name != "count"}, count=n)
