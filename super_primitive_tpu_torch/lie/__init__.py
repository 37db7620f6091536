"""SO(3)/SE(3)/Sim(3) in PyTorch (port of ``super_primitive_tpu/lie``)."""

from . import se3, sim3, so3

__all__ = ["so3", "se3", "sim3"]
