"""Pallas kernels, lowered through Triton for the GPU.

Each has a plain-JAX twin that is its parity reference: the SPH run walk
(``sph_walk``) against ``ops/grid_step.py`` and ``ops/reference_step.py``, the
N-body kernel (``nbody``) against ``models/nbody.py``.  ``interpret=True`` runs them
in the Pallas interpreter, which is how the CPU tests reach them.
"""

from .nbody import nbody_accel_pallas
from .sph_walk import walk_physics, walk_quantities, walk_step

__all__ = [
    "nbody_accel_pallas",
    "walk_physics",
    "walk_quantities",
    "walk_step",
]
