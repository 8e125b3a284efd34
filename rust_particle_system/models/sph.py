"""Flagship model: the 2D SPH fluid, capability-matching the whole reference app.

Bundles the reference's full per-frame pipeline (grid build -> density -> pressure +
viscosity -> integrate -> bounce -> colour, `src/particle_compute.rs:91-195`) plus its
render pass into the Model protocol.  Backends (``"auto"`` is decided in
``rust_particle_system/platform.py``):

* ``backend="pallas"`` — the run walk: sort by cell key, then two Pallas-Triton
  launches walk the sorted neighbour runs (``ops/pallas/sph_walk.py``).  Lossless: no
  per-cell capacity, so no particle ever loses forces.  The GPU path.
* ``backend="grid"``  — the plain XLA spatial-grid step with a per-cell capacity
  (``ops/grid_step.py``).  The CPU path and the walk's parity anchor.
* ``backend="oracle"`` — all-pairs O(n²) step (small n, exact spec).
"""

from __future__ import annotations

import dataclasses

import jax

from .. import platform
from ..core.params import SimParams, make_params
from ..core.state import ParticleState, scatter_init
from ..ops.grid import GridSpec, suggest_capacity
from ..ops.grid_step import grid_step
from ..ops.pallas.sph_walk import walk_step
from ..ops.reference_step import reference_step
from ..render import RenderSpec, splat

# Capacity of the grid step's slot table: 16x the mean occupancy, which a settled
# pool (~101 per 9x9 cell) stays under at the reference's density.
CAPACITY_SAFETY = 16.0


@dataclasses.dataclass(frozen=True)
class SPHFluid:
    grid: GridSpec | None
    render_spec: RenderSpec
    bounds: tuple
    backend: str = "grid"
    chunk_cells: int = 256
    interpret: bool = False  # pallas backend: run the kernels in the interpreter

    @classmethod
    def create(
        cls,
        n: int = 50_000,
        bounds=(-960.0, 960.0, -540.0, 540.0),
        cell_size: float | None = None,
        capacity: int | None = None,
        backend: str = "auto",
        render_spec: RenderSpec | None = None,
        interpret: bool = False,
    ) -> "SPHFluid":
        backend = platform.resolve_backend("sph", backend, interpret)
        params = make_params(bounds=bounds)
        if cell_size is None:
            # grid cell size = smoothing radius, as the reference ties them (main.rs:88)
            cell_size = float(params.smoothing_radius)
        grid = None
        if backend == "grid":
            if capacity is None:
                capacity = suggest_capacity(n, bounds, cell_size, safety=CAPACITY_SAFETY)
            grid = GridSpec.from_bounds(bounds, cell_size, capacity)
        elif backend == "pallas":
            grid = GridSpec.from_bounds(bounds, cell_size)
        return cls(
            grid=grid,
            render_spec=render_spec or RenderSpec(),
            bounds=tuple(float(b) for b in bounds),
            backend=backend,
            interpret=bool(interpret),
        )

    def default_params(self) -> SimParams:
        return make_params(bounds=self.bounds)

    def init(self, key: jax.Array, n: int) -> ParticleState:
        return scatter_init(key, n, self.bounds)

    def step(self, state: ParticleState, params: SimParams) -> ParticleState:
        if self.backend == "pallas":
            return walk_step(state, params, self.grid, self.interpret)
        if self.backend == "grid":
            return grid_step(state, params, self.grid, self.chunk_cells)
        return reference_step(state, params)

    def render(self, state: ParticleState, params: SimParams, camera=None):
        """Render the state; ``camera`` is a traced (cx, cy, zoom) pan/zoom triple —
        the per-frame view_proj analog (src/particle_buffers.rs:220-236)."""
        return splat(
            state.pos, state.color, params.particle_size, params.bounds,
            self.render_spec, camera=camera,
        )

    def step_and_render(self, state: ParticleState, params: SimParams):
        """One frame: physics, then the image of the new state."""
        new_state = self.step(state, params)
        return new_state, self.render(new_state, params)
