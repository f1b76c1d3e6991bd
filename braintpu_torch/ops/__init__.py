"""Hand-written Hopper kernels and their plain PyTorch versions."""

from .conv3d import conv3d_tap_merged

__all__ = ["conv3d_tap_merged"]
