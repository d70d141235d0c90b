"""Learning-curve data for the port (synthetic task sampler so far)."""
from .curves import CurveTask, sample_task

__all__ = ["CurveTask", "sample_task"]
