from . import checkpoint, debug, profiling
from .simulation import Simulation, run_frames, run_frames_trajectory

__all__ = [
    "Simulation",
    "run_frames",
    "run_frames_trajectory",
    "checkpoint",
    "debug",
    "profiling",
]
