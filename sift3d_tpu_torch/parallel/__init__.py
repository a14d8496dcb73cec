"""Batched and mesh-sharded pipelines (the port of ``sift3d_tpu/parallel``):
one device, or a (data, space) mesh of ``torch.distributed`` ranks."""

from .mesh import factor_devices, init_distributed, make_mesh
from .pipeline import batch_detect_describe, batch_register_pairs
from .shard_conv import conv_sep_sharded, shard_halo
from .shard_extrema import level_extrema_sharded
from .shard_match import nn_match_ring, nn_match_sharded
from .shard_windows import (descrip_level_sharded, descrip_level_z_sharded,
                            orient_level_sharded, orient_level_z_sharded)

__all__ = ["batch_detect_describe", "batch_register_pairs",
           "conv_sep_sharded", "descrip_level_sharded",
           "descrip_level_z_sharded", "factor_devices", "init_distributed",
           "level_extrema_sharded", "make_mesh", "nn_match_ring",
           "nn_match_sharded", "orient_level_sharded",
           "orient_level_z_sharded", "shard_halo"]
