"""Checkpoint / resume for batch registration fleets.

The port of ``sift3d_tpu/utils/checkpoint.py``, in its file formats, so
that either package reads what the other wrote. The reference's nearest
analog is artifact serialization (keypoint / descriptor / transform CSV;
SURVEY §5.4). Descriptor sets and transforms persist per volume / per
pair, so a groupwise or batch registration job can be killed and
re-launched idempotently (SURVEY §5.3: recovery = re-run the missing
shard). Every write goes to a temporary name in the same directory and is
renamed into place, so a reader never sees a partial file.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch

from ..dtypes import resolve_device
from ..features.descriptor import Descriptors
from ..features.keypoints import Keypoints


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _savez(path, **arrays) -> pathlib.Path:
    """``np.savez_compressed`` to ``path`` (".npz" appended as numpy
    does) through a temporary file whose name starts with ``.tmp_``."""
    p = pathlib.Path(path)
    if not p.name.endswith(".npz"):
        p = p.with_name(p.name + ".npz")
    tmp = p.with_name(f".tmp_{p.name}")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, p)
    return p


def _padded(a: np.ndarray, cap: int, dtype, device) -> torch.Tensor:
    n = min(len(a), cap)
    out = np.zeros((cap,) + a.shape[1:], dtype)
    out[:n] = a[:n]
    return torch.as_tensor(out).to(device)


def save_descriptors(path: str, desc: Descriptors) -> None:
    """Persist a descriptor set (trimmed to count) as .npz."""
    n = int(desc.count)
    _savez(path, xyz=_numpy(desc.xyz)[:n], sd=_numpy(desc.sd)[:n],
           vec=_numpy(desc.vec)[:n])


def load_descriptors(path: str, capacity: int | None = None,
                     device=None) -> Descriptors:
    """Load a descriptor set onto ``device`` (None: the card), padding to
    ``capacity`` rows (default: count)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        xyz, sd, vec = z["xyz"], z["sd"], z["vec"]
    n = len(vec)
    cap = capacity or max(n, 1)
    return Descriptors(xyz=_padded(xyz, cap, np.float64, dev),
                       sd=_padded(sd, cap, np.float64, dev),
                       vec=_padded(vec, cap, np.float32, dev),
                       count=min(n, cap))


def save_keypoints(path: str, kp: Keypoints) -> None:
    """Persist a keypoint set as .npz: its [x y z o sd R00..R22] rows and
    its level indices."""
    _savez(path, rows=kp.to_numpy(), s=_numpy(kp.s)[:int(kp.count)])


def load_keypoints(path: str, capacity: int | None = None,
                   device=None) -> Keypoints:
    """Inverse of :func:`save_keypoints` onto ``device`` (None: the
    card), padding to ``capacity`` rows."""
    dev = resolve_device(device)
    with np.load(path) as z:
        rows, s = z["rows"], z["s"]
    n = len(rows)
    cap = capacity or max(n, 1)
    return Keypoints(
        x=_padded(rows[:, 0], cap, np.float64, dev),
        y=_padded(rows[:, 1], cap, np.float64, dev),
        z=_padded(rows[:, 2], cap, np.float64, dev),
        o=_padded(rows[:, 3], cap, np.int32, dev),
        s=_padded(s, cap, np.int32, dev),
        sd=_padded(rows[:, 4], cap, np.float64, dev),
        R=_padded(rows[:, 5:].reshape(n, 3, 3), cap, np.float32, dev),
        count=min(n, cap))


class GroupwiseCheckpoint:
    """Per-edge matched-correspondence store for resumable groupwise
    registration fleets.

    The matching phase (the expensive part: detect + extract + NN match
    per edge) checkpoints each edge's matched point pairs; a re-launched
    job skips finished edges (``has``) and the solve phase gathers every
    edge back into the padded arrays ``groupwise_solve`` expects.
    """

    def __init__(self, directory: str):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, i: int, j: int) -> pathlib.Path:
        return self.dir / f"edge_{int(i)}_{int(j)}.npz"

    def has(self, i: int, j: int) -> bool:
        return self._path(i, j).exists()

    def put(self, i: int, j: int, src_pts, ref_pts, count: int) -> None:
        n = int(count)
        # The temporary name (".tmp_edge_...") does not match the
        # edge_*.npz glob, so a preemption mid-write leaves nothing that
        # the resume scan below would read.
        _savez(self._path(i, j), src=_numpy(src_pts)[:n],
               ref=_numpy(ref_pts)[:n])

    def get(self, i: int, j: int):
        with np.load(self._path(i, j)) as z:
            return z["src"], z["ref"]

    def edges(self) -> list[tuple[int, int]]:
        out = []
        for p in sorted(self.dir.glob("edge_*.npz")):
            parts = p.stem.split("_")
            if len(parts) != 3 or not (parts[1].isdigit() and
                                       parts[2].isdigit()):
                continue             # stray file, not an edge record
            out.append((int(parts[1]), int(parts[2])))
        return out

    def gather(self, edges_ij, capacity: int | None = None):
        """Load ``edges_ij`` into padded (E, M, 3) float64 numpy arrays +
        (E,) int32 counts."""
        pts = [self.get(i, j) for i, j in edges_ij]
        cap = capacity or max((len(s) for s, _ in pts), default=1)
        E = len(pts)
        src = np.zeros((E, cap, 3))
        ref = np.zeros((E, cap, 3))
        cnt = np.zeros(E, np.int32)
        for e, (s, r) in enumerate(pts):
            n = min(len(s), cap)
            src[e, :n], ref[e, :n], cnt[e] = s[:n], r[:n], n
        return src, ref, cnt


class RegistrationCheckpoint:
    """Per-pair transform store with atomic JSON records.

    Usage:
        ckpt = RegistrationCheckpoint(dir)
        for pair in pairs:
            if ckpt.has(pair): continue       # resume: skip finished work
            ... register ...
            ckpt.put(pair, A, num_inliers)
    """

    def __init__(self, directory: str):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, key) -> pathlib.Path:
        name = "_".join(str(k) for k in key) \
            if isinstance(key, (tuple, list)) else str(key)
        return self.dir / f"pair_{name}.json"

    def has(self, key) -> bool:
        return self._path(key).exists()

    def put(self, key, A, num_inliers: int = -1, ok: bool = True) -> None:
        rec = {"A": np.asarray(_numpy(A), np.float64).tolist(),
               "num_inliers": int(num_inliers), "ok": bool(ok)}
        p = self._path(key)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(rec))
        os.replace(tmp, p)

    def get(self, key):
        rec = json.loads(self._path(key).read_text())
        return (np.asarray(rec["A"], np.float64), rec["num_inliers"],
                rec["ok"])

    def keys(self):
        for p in sorted(self.dir.glob("pair_*.json")):
            yield p.stem[len("pair_"):]
