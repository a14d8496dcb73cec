"""Roofline accounting for the pipeline's dense stages.

The port of ``sift3d_tpu/utils/roofline.py``. StageTimer gives wall-clock;
this module adds analytic bytes-moved and useful-FLOP counts per stage
from the static plan, so a timed run reports achieved GB/s and FLOP/s
against the card's peaks. Counts are *useful* work (e.g. the separable
convolution is costed at 2*taps MACs/voxel/axis even though the
banded-matmul implementation issues more MACs), so the percentages are
algorithmic efficiency, not implementation flattery.

Peaks are one NVIDIA H100 SXM's data-sheet rates at its 700 W limit:
3.35 TB/s of HBM, 67 TFLOP/s fp32 and 34 TFLOP/s fp64 outside the tensor
cores (the port keeps its products in full fp32, ``dtypes.full_fp32``).
A card set to a lower power limit runs slower than these under load.
"""

from __future__ import annotations

import dataclasses

from . import trace


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    hbm_gbps: float
    fp32_tflops: float
    fp64_tflops: float
    name: str = "chip"


H100_SXM = ChipPeaks(hbm_gbps=3350.0, fp32_tflops=67.0, fp64_tflops=34.0,
                     name="h100-sxm")


@dataclasses.dataclass
class StageCost:
    """Bytes moved between device memory and the cores, and useful
    floating-point ops."""
    bytes_moved: float = 0.0
    flops: float = 0.0

    def __add__(self, o: "StageCost") -> "StageCost":
        return StageCost(self.bytes_moved + o.bytes_moved,
                         self.flops + o.flops)

    def scaled(self, k: float) -> "StageCost":
        return StageCost(self.bytes_moved * k, self.flops * k)


def _vox(dims) -> float:
    nx, ny, nz = dims
    return float(nx) * ny * nz


def pyramid_cost(plan) -> StageCost:
    """GSS build: first blur + per-level incremental separable blurs
    (reference apply_Sep_FIR_filter, imutil.c:3459-3544: 3 passes per
    blur, each streaming the level once in and once out) + the 2x
    downsample picks, + DoG subtractions (build_dog, sift.c:1052-1071)."""
    by = 0.0
    fl = 0.0
    for o in range(plan.num_octaves):
        v = _vox(plan.octave_dims(o))
        for s in range(plan.first_level, plan.last_gpyr_level + 1):
            taps = len(plan.first_gauss_taps()) if \
                (o == 0 and s == plan.first_level) else \
                (0 if s == plan.first_level else
                 len(plan.octave_filter_taps(s)))
            if taps == 0:
                continue                      # copied/downsampled level
            by += 3 * 2 * 4 * v               # 3 axis passes, r+w f32
            fl += 3 * 2 * taps * v            # MAC = 2 flops
        # DoG: read 2 gpyr levels, write 1, per dog level
        n_dog = plan.num_dog_levels
        by += n_dog * 3 * 4 * v
        fl += n_dog * v
    return StageCost(by, fl)


def extrema_cost(plan) -> StageCost:
    """Strict 6+2-neighborhood scan over each keypoint level's DoG
    triple (detect_extrema, sift.c:1074-1212): reads 3 levels per kp
    level, ~9 compares/voxel."""
    by = 0.0
    fl = 0.0
    for o in range(plan.num_octaves):
        v = _vox(plan.octave_dims(o))
        n_kp = plan.num_dog_levels - 2
        by += n_kp * 3 * 4 * v
        fl += n_kp * 9 * v
    return StageCost(by, fl)


def descriptor_cost(n_keypoints: float, window_vox: float) -> StageCost:
    """Per-keypoint window gather + histogram accumulation
    (extract_descrip, sift.c:1834-1928): stream the window once; per
    voxel ~60 flops of geometry (gradient, rotation, binning) plus the
    (16,48) x (48, x) histogram matmul at 2*16*48 flops/voxel."""
    per_vox = 60.0 + 2 * 16 * 48
    return StageCost(n_keypoints * window_vox * 4,
                     n_keypoints * window_vox * per_vox)


def match_cost(n1: float, n2: float, dim: int = 768) -> StageCost:
    """Brute-force SSD matching as a Gram matmul (SIFT3D_nn_match,
    sift.c:2840-2888): 2*n1*n2*dim flops, descriptor reads + the
    (n1, n2) distance matrix."""
    return StageCost((n1 + n2) * dim * 4 + n1 * n2 * 4,
                     2.0 * n1 * n2 * dim)


def batch_register_cost(plan, n_kp_per_vol: float, window_vox: float,
                        batch: int) -> StageCost:
    """Config-4 shape: both sides of `batch` pairs through pyramid ->
    extrema -> descriptors, then matching (RANSAC is negligible)."""
    per_vol = pyramid_cost(plan) + extrema_cost(plan) + \
        descriptor_cost(n_kp_per_vol, window_vox)
    per_pair = per_vol.scaled(2) + match_cost(n_kp_per_vol, n_kp_per_vol)
    return per_pair.scaled(batch)


# Stages timed below this are seam residuals / sync noise, not
# measurements: dividing a cost model by them fabricates shares of peak
# far above 100%.
MIN_STAGE_SECONDS = 1e-3


def roofline_report(stage_seconds: dict[str, float],
                    stage_costs: dict[str, StageCost],
                    peaks: ChipPeaks = H100_SXM,
                    n_chips: int = 1) -> list[dict]:
    """Achieved GB/s / TFLOP/s and % of peak per timed stage (the FLOPs
    against the fp32 peak). Emits one structured record per stage through
    utils.trace and returns them. Stages shorter than MIN_STAGE_SECONDS
    are dropped (divide-by-epsilon guard)."""
    out = []
    for name, sec in stage_seconds.items():
        cost = stage_costs.get(name)
        if cost is None or sec < MIN_STAGE_SECONDS:
            continue
        gbps = cost.bytes_moved / sec / 1e9
        tflops = cost.flops / sec / 1e12
        rec = {
            "kind": "roofline", "stage": name, "chip": peaks.name,
            "seconds": round(sec, 6),
            "achieved_GBps": round(gbps, 2),
            "hbm_pct_peak": round(100 * gbps /
                                  (peaks.hbm_gbps * n_chips), 1),
            "achieved_TFLOPs": round(tflops, 3),
            "fp32_pct_peak": round(100 * tflops /
                                   (peaks.fp32_tflops * n_chips), 2),
        }
        trace._emit(rec)
        out.append(rec)
    return out
