"""Host-side IO. The port has the synthetic scan renderer so far."""

from .synthetic import Box, default_world, render_scan, render_trajectory

__all__ = ["Box", "default_world", "render_scan", "render_trajectory"]
