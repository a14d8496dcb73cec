"""What the pair entries share: the pool of volume pairs, the port's
parameters from the configuration file, the work counts of a traced
slice and the judging of the kept outputs against the reference.

A request takes ``pairs_per_request`` pairs of the pool's next item (the
items in turn); each ref is its src rolled ``shift_x`` voxels along x.
"""

from __future__ import annotations

import numpy as np
import torch

from . import compare, volumes
from .work.descrip import descrip_work
from .work.pyramid import pyramid_work


def port_params(cfg: dict):
    """The port's SIFT3D, match and RANSAC parameters of a configuration
    file."""
    from sift3d_tpu_torch.config import MatchParams, RansacParams, SIFT3DParams
    s = dict(cfg["sift3d"])
    if s.get("max_kp_per_octave") is not None:
        s["max_kp_per_octave"] = tuple(s["max_kp_per_octave"])
    return (SIFT3DParams(**s), MatchParams(**cfg["match"]),
            RansacParams(**cfg["ransac"]))


class PairEntry:
    """Base of the entries whose request registers pairs."""
    unit = "pairs"

    def __init__(self, cell, device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.shape = tuple(self.cfg["shape_zyx"])
        self.units = tuple(float(u) for u in self.cfg["units"])
        self.per = int(self.traffic["pairs_per_request"])
        self.pool = []

    def make_pool(self, seed: int) -> None:
        """The pool's items, (src, ref) host float32 stacks of ``per``
        pairs, made on the device from the seed and copied once."""
        t = self.traffic
        n = int(t["pool"]) * self.per
        gen = volumes.generator(seed, self.device)
        src, ref = volumes.pairs(n, self.shape, int(t["nblob"]),
                                 int(t["shift_x"]), gen, self.device)
        src, ref = src.cpu().numpy(), ref.cpu().numpy()
        self.pool = [(src[a:a + self.per], ref[a:a + self.per])
                     for a in range(0, n, self.per)]

    def done(self, out) -> int:
        return self.per

    def work(self, items, names) -> dict:
        """The work counts ``names`` of the requests on pool ``items``."""
        from .reference.pyramid import plan_pyramid
        params = compare.reference_params(self.cfg)[0]
        nz, ny, nx = self.shape
        plan = plan_pyramid((nx, ny, nz), self.units, params)
        out = {}
        if "pyramid" in names:
            b, f = pyramid_work(plan, 2 * self.per)
            out["pyramid"] = (b * len(items), f * len(items))
        if "descrip" in names:
            per_item = {}
            for i in set(items):
                b = f = 0.0
                for vols in self.pool[i]:
                    for a in range(0, len(vols), 32):
                        bb, ff = descrip_work(vols[a:a + 32], plan, params,
                                              self.device)
                        b, f = b + bb, f + ff
                per_item[i] = (b, f)
            out["descrip"] = tuple(sum(per_item[i][k] for i in items)
                                   for k in range(2))
        return out

    def outputs(self, out) -> list:
        """The PairOuts of one request's output, host side."""
        raise NotImplementedError

    def judge(self, kept: dict, seed: int,
              sides=("program",)) -> dict:
        """The numbers compared, per side: the kept outputs (pool item ->
        one request's output), ``sample`` pairs drawn from the seed (all of
        them when fewer), against the reference on the same pairs. The
        side "control" is the reference computed with TF32 in the port's
        place, which has to come out as not correct."""
        rng = np.random.default_rng(int(seed) % 2 ** 63)
        picks = [(i, b) for i in sorted(kept) for b in range(self.per)]
        k = min(len(picks), int(self.traffic["sample"]))
        picks = [picks[j] for j in sorted(rng.choice(len(picks), k,
                                                     replace=False))]
        src = np.stack([self.pool[i][0][b] for i, b in picks])
        ref = np.stack([self.pool[i][1][b] for i, b in picks])
        outs = {i: self.outputs(kept[i]) for i in {i for i, _ in picks}}
        got = {"program": [outs[i][b] for i, b in picks]}
        del outs
        want = compare.reference_pairs(src, ref, self.cfg, self.device)
        if "control" in sides:
            got["control"] = compare.reference_pairs(
                src, ref, self.cfg, self.device, tf32=True)
        return {side: compare.pair_numbers(got[side], want, self.shape)
                for side in sides}
