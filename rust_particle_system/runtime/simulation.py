"""Simulation driver: scanned frame loops with donated state, and the GUI analog.

The reference advances one frame per render-graph execution, with parameters mutable
every frame from egui sliders (`src/parameter_gui.rs`).  This driver instead runs
**chunks of frames inside one ``lax.scan``** (state ping-pongs entirely on-device via
buffer donation — the analog of the reference's persistent storage buffers), and the
host mutates the params pytree *between* chunks.  Because every parameter is a traced
scalar, feeding new values re-uses the compiled executable.
"""

from __future__ import annotations

import functools
from typing import Any

import jax

from ..core.state import ParticleState

# Tunable-parameter guardrails, mirroring the reference's egui slider ranges
# (src/parameter_gui.rs:38-70).  The reference physically cannot receive values
# outside these (sliders clamp); accepting them here would let a REPL `set` pass a
# negative dt or a zero radius (whose kernel norms divide by h^5) straight into the
# compiled step.  Keys not listed (particle_size, shader_delay, model-specific
# fields) are unconstrained, as in the reference.
PARAM_RANGES = {
    "dt": (0.0015, 0.015),
    "gravity": (0.0, 1000.0),
    "damping_factor": (0.0, 1.0),
    "smoothing_radius": (1e-6, 30.0),  # exclusive 0: norms divide by h^5..h^8
    "max_energy": (1000.0, 10000.0),
    "target_density": (0.0, 0.1),
    "pressure_multiplier": (1.0, 100000.0),
    "viscosity_strength": (0.0, 10.0),
    "near_density_multiplier": (1.0, 10000.0),
}


def check_param_ranges(**kwargs) -> None:
    """Raise ValueError for any tunable outside its reference slider range."""
    for k, v in kwargs.items():
        rng = PARAM_RANGES.get(k)
        if rng is None:
            continue
        lo, hi = rng
        v = float(v)
        if not (lo <= v <= hi):
            raise ValueError(
                f"{k}={v} is outside the supported range [{lo}, {hi}] "
                f"(the reference GUI clamps it there, src/parameter_gui.rs:38-70)"
            )


@functools.partial(jax.jit, static_argnames=("step_fn", "num_frames"), donate_argnums=1)
def run_frames(step_fn, state: ParticleState, params: Any, num_frames: int) -> ParticleState:
    """Advance ``num_frames`` frames under one scan; state stays on-device."""

    def body(carry, _):
        return step_fn(carry, params), None

    state, _ = jax.lax.scan(body, state, None, length=num_frames)
    return state


@functools.partial(
    jax.jit, static_argnames=("step_fn", "num_frames", "save_every"), donate_argnums=1
)
def run_frames_trajectory(step_fn, state, params, num_frames: int, save_every: int = 1):
    """Like run_frames but stacks every ``save_every``-th frame's positions.

    Scans over chunks of ``save_every`` frames so only num_frames/save_every
    snapshots ever materialize (stacking every frame then slicing would allocate
    save_every-times more memory than requested).  Every step keeps particles in
    their original order, so ``traj[:, i]`` is the same particle i across frames."""
    assert num_frames % save_every == 0, "num_frames must divide by save_every"

    def chunk(carry, _):
        def body(c, _):
            return step_fn(c, params), None

        new, _ = jax.lax.scan(body, carry, None, length=save_every)
        return new, new.pos

    state, traj = jax.lax.scan(chunk, state, None, length=num_frames // save_every)
    return state, traj


class Simulation:
    """Host-side convenience wrapper: model + live-tunable params + device state.

    ``update_params(gravity=500)`` is the egui-slider analog
    (`src/parameter_gui.rs:78-103`): it replaces fields in the params pytree; the next
    ``run()`` call feeds them to the already-compiled step.  Changing
    ``smoothing_radius`` recomputes the kernel norms exactly as the reference does —
    use :func:`rust_particle_system.core.params.with_smoothing_radius` via the
    dedicated kwarg handling below.
    """

    def __init__(self, model, n: int, seed: int = 0, params=None):
        self.model = model
        self.n = n
        self.params = params if params is not None else model.default_params()
        self.state = model.init(jax.random.key(seed), n)

    def update_params(self, **kwargs):
        check_param_ranges(**kwargs)
        if "smoothing_radius" in kwargs and hasattr(self.params, "density_kernel_norm"):
            from ..core.params import with_smoothing_radius

            radius = float(kwargs["smoothing_radius"])
            grid = getattr(self.model, "grid", None)
            if grid is not None and radius > grid.cell_size:
                # The 3x3 neighborhood only sees one cell in every direction: a radius
                # above the cell size would silently miss interactions (ops/grid.py).
                raise ValueError(
                    f"smoothing_radius {radius} exceeds the grid cell size "
                    f"{grid.cell_size}; rebuild the model with a "
                    f"larger cell_size to raise the radius (lowering it is free)"
                )
            self.params = with_smoothing_radius(
                self.params, kwargs.pop("smoothing_radius")
            )
        if kwargs:
            import jax.numpy as jnp

            casted = {
                k: jnp.asarray(v, getattr(self.params, k).dtype)
                for k, v in kwargs.items()
            }
            self.params = self.params._replace(**casted)
        return self.params

    def run(self, num_frames: int):
        """Advance frames under one scan (its jit keys on ``num_frames``)."""
        self.state = run_frames(self.model.step, self.state, self.params, num_frames)
        return self.state

    def render(self, camera=None):
        """Render the current state.  ``camera`` = (cx, cy, zoom) pan/zoom triple,
        traced — changing it re-uses the compiled render (the per-frame view_proj
        analog, src/particle_buffers.rs:220-236)."""
        import jax.numpy as jnp

        if camera is not None:
            camera = jnp.asarray(camera, jnp.float32)
        return self.model.render(self.state, self.params, camera=camera)

    def stats(self) -> dict:
        """Validate the current state and return summary statistics.

        Raises ValueError on violated invariants (non-finite values, out-of-bounds
        positions) — the always-on version of the reference's disabled debug
        readbacks.  For grid-backed models, also reports cell occupancy and, for a
        model with a slot-table capacity, the CURRENT state's overflow (particles
        beyond a cell's slot budget exert/receive no grid forces — a nonzero value
        means the capacity should be raised).  The run walk has no capacity."""
        from .debug import validate_grid, validate_state

        out = validate_state(self.state, self.params)
        grid_spec = getattr(self.model, "grid", None)
        if grid_spec is not None:
            from ..ops.grid import build_grid

            grid = build_grid(grid_spec, self.state.pos)
            gstats = validate_grid(grid, grid_spec, self.state.pos.shape[0])
            out.update({f"grid_{k}": v for k, v in gstats.items()})
        return out
