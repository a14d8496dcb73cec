"""Register the chip-smoke 256^3 pair with the JAX package on the CPU.

``chip_smoke.py`` holds the PyTorch port to the reference's accuracy
contract on one synthetic 256^3 pair (``benches.data.make_volume`` with
nblob=256, and its copy rolled by ``SHIFT`` voxels along x). This script
checks that the JAX package itself registers that pair within the same
contract, so a failure on the card points at the port and not at the
pair. It runs the same stages as ``sift3d_tpu.api.RegSift3D.register``
(detect, extract, ``register_pair``) with a small descriptor chunk to keep
host memory low.

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python scripts/jax_reference_pair.py [seed]

Prints one JSON line: seed, keypoint counts, matches, inliers, the affine
and whether it passes ``benches.data.pair_ok``.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from benches.data import SHIFT, make_volume, pair_ok  # noqa: E402


def main(seed: int = 7, size: int = 256) -> dict:
    import jax

    from sift3d_tpu.api import Sift3D
    from sift3d_tpu.config import MatchParams, RansacParams, SIFT3DParams
    from sift3d_tpu.features.descriptor import extract_descriptors
    from sift3d_tpu.features.detect import kp_levels
    from sift3d_tpu.features.keypoints import head
    from sift3d_tpu.register.pipeline import register_pair

    t0 = time.perf_counter()
    src = make_volume((size,) * 3, nblob=256, seed=seed)
    ref = np.roll(src, SHIFT, axis=2)
    params = SIFT3DParams()
    units = (1.0, 1.0, 1.0)
    descs, counts = [], []
    for vol in (src, ref):
        s3d = Sift3D(params)
        kp = s3d.detect(vol, units)
        n = int(kp.count)
        lvl = np.asarray(s3d._lvl_counts)
        caps = {lv: int(c) for lv, c in zip(sorted(kp_levels(s3d._plan)),
                                            lvl)}
        descs.append(extract_descriptors(s3d._gpyr, head(kp, n), s3d._plan,
                                         params, chunk=4, level_caps=caps))
        counts.append(n)
    res = register_pair(descs[0], descs[1], units, units, MatchParams(),
                        RansacParams())
    A = np.asarray(jax.device_get(res.A))
    out = {"seed": seed, "size": size, "kp": counts,
           "matches": int(res.num_matches),
           "inliers": int(res.num_inliers), "ok": bool(res.ok),
           "pair_ok": bool(pair_ok(A)), "A": A.round(6).tolist(),
           "seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
