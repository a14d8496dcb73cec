"""Entry: ``parallel.pipeline.batch_register_pairs``, the port's batched
pairwise registration (config 4): one request registers the
``pairs_per_request`` pairs of one pool item in one call, from host
float32 stacks, and ends in a sync on its device outputs."""

from __future__ import annotations

from portbench import compare
from portbench.pairs import PairEntry, port_params


class Entry(PairEntry):
    def __init__(self, cell, device):
        super().__init__(cell, device)
        from sift3d_tpu_torch import pyramid
        from sift3d_tpu_torch.parallel.pipeline import batch_register_pairs
        self.params, self.match, self.ransac = port_params(self.cfg)
        nz, ny, nx = self.shape
        self.plan = pyramid.plan_pyramid((nx, ny, nz), self.units,
                                         self.params)
        self.fn = batch_register_pairs

    def request(self, i: int):
        src, ref = self.pool[i]
        return self.fn(src, ref, self.plan, self.params, self.units,
                       self.match, self.ransac, device=self.device)

    def outputs(self, out) -> list:
        return compare.pair_outs(out)

    def close(self) -> None:
        self.fn = self.plan = None
