"""Batched pipelines on one GPU (the port of ``sift3d_tpu/parallel``'s
single-device branch; the mesh-sharded paths are not ported)."""

from .pipeline import batch_detect_describe, batch_register_pairs

__all__ = ["batch_detect_describe", "batch_register_pairs"]
