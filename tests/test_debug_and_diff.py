"""Tests for debug validators, profiling helpers, and differentiability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rust_particle_system.core.params import make_params
from rust_particle_system.core.state import make_state, scatter_init
from rust_particle_system.ops.grid import GridSpec, build_grid
from rust_particle_system.ops.reference_step import reference_step
from rust_particle_system.runtime.debug import (
    print_config,
    validate_grid,
    validate_state,
)
from rust_particle_system.runtime.profiling import PhaseTimer

BOUNDS = (-100.0, 100.0, -50.0, 50.0)


def test_validate_grid_accepts_valid_and_reports_stats(rng):
    n = 300
    pos = jnp.asarray(
        np.stack([rng.uniform(-100, 100, n), rng.uniform(-50, 50, n)], -1), jnp.float32
    )
    spec = GridSpec.from_bounds(BOUNDS, 9.0, capacity=32)
    grid = build_grid(spec, pos)
    stats = validate_grid(grid, spec, n)
    assert stats["cells_used"] > 0
    assert stats["overflow"] == 0
    assert stats["max_occupancy"] >= 1


def test_validate_state_detects_nan():
    params = make_params(bounds=BOUNDS)
    state = make_state(np.zeros((4, 2), np.float32))
    bad = state._replace(pos=state.pos.at[0, 0].set(jnp.nan))
    with pytest.raises(ValueError, match="non-finite"):
        validate_state(bad, params)
    # good state passes and reports
    stats = validate_state(state, params)
    assert stats["n"] == 4


def test_print_config_lists_all_fields(capsys):
    params = make_params()
    text = print_config(params)
    for field in params._fields:
        assert field in text


def test_phase_timer_accumulates():
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("work"):
            pass
    stats = t.report()
    assert stats["work"]["calls"] == 3


def test_simulation_step_is_differentiable():
    """The whole SPH frame differentiates — a capability the reference cannot have.

    Optimizes gravity so the fluid's centre of mass after 3 frames hits a target
    height: the gradient must be finite, nonzero, and pointing the right way
    (more gravity -> lower centre of mass).
    """
    params = make_params(bounds=BOUNDS, shader_delay=0)
    state = scatter_init(jax.random.key(0), 64, BOUNDS)

    def loss(gravity):
        p = params._replace(gravity=gravity)
        s = state
        for _ in range(3):
            s = reference_step(s, p)
        return jnp.mean(s.pos[:, 1])  # centre-of-mass height

    g = jax.grad(loss)(jnp.float32(100.0))
    assert np.isfinite(float(g))
    assert float(g) < 0.0  # d(height)/d(gravity) < 0


def test_grid_step_is_differentiable(rng):
    from rust_particle_system.ops.grid_step import grid_step

    spec = GridSpec.from_bounds(BOUNDS, 9.0, capacity=32)
    params = make_params(bounds=BOUNDS, shader_delay=0)
    n = 128
    pos = jnp.asarray(
        np.stack([rng.uniform(-100, 100, n), rng.uniform(-50, 50, n)], -1), jnp.float32
    )
    state = make_state(pos)

    def loss(gravity):
        p = params._replace(gravity=gravity)
        s = grid_step(state, p, spec)
        return jnp.mean(s.pos[:, 1])

    g = jax.grad(loss)(jnp.float32(100.0))
    assert np.isfinite(float(g)) and float(g) < 0.0
