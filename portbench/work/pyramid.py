"""The work that the Gaussian and DoG pyramids of a batch need.

Operations: each blur of the plan applies its taps along each of the
three axes, 2 (2H + 1) FLOP a voxel an axis for 2H + 1 taps (a multiply
and an add each); each DoG voxel is 1 subtraction. Bytes: the input
volumes read once, and every Gaussian and DoG level written once (4 bytes
a voxel). The count reads the plan alone, never the matmul sizes of the
dense or framed form that the port picks, so a change of form does not
move it.
"""

from __future__ import annotations

import numpy as np

from ..reference.pyramid import PyramidPlan


def pyramid_work(plan: PyramidPlan, batch: int) -> tuple[float, float]:
    """(bytes, fp32 FLOP) of the pyramids of ``batch`` volumes."""
    flops = 0.0
    written = 0
    for o in range(plan.num_octaves):
        vox = int(np.prod(plan.octave_dims(o)))
        blurs = [plan.octave_filter_taps(s)
                 for s in range(plan.first_level + 1,
                                plan.last_gpyr_level + 1)]
        if o == 0:
            blurs.append(plan.first_gauss_taps())
        flops += sum(3 * 2 * len(t) * vox for t in blurs)
        flops += plan.num_dog_levels * vox
        written += (plan.num_gpyr_levels + plan.num_dog_levels) * vox
    read = int(np.prod(plan.dims))
    return 4.0 * batch * (read + written), float(batch) * flops
