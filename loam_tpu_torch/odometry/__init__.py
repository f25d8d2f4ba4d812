"""Odometry drivers. The port has the batched offline driver so far."""

from .offline import odometry_offline

__all__ = ["odometry_offline"]
