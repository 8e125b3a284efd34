"""Tests for the native C++ host engine: SPH oracle parity + binary IO."""

import numpy as np
import pytest

from rust_particle_system.core.params import make_params
from rust_particle_system.core.state import make_state

try:
    from rust_particle_system.native import (
        native_sph_step,
        native_state_load,
        native_state_save,
    )
    _AVAILABLE = True
except Exception:  # pragma: no cover
    _AVAILABLE = False

pytestmark = pytest.mark.skipif(not _AVAILABLE, reason="no C++ toolchain")

BOUNDS = (-100.0, 100.0, -50.0, 50.0)


def _random_state(rng, n, vmax=20.0, min_sep=None):
    """Random state; optionally rejection-resample until the minimum pairwise
    distance is >= min_sep (conditioning knob for cross-implementation
    comparisons near the spiky kernel's d -> 0 divergence)."""
    pos = np.stack(
        [rng.uniform(BOUNDS[0], BOUNDS[1], n), rng.uniform(BOUNDS[2], BOUNDS[3], n)],
        axis=-1,
    ).astype(np.float32)
    for _ in range(64 if min_sep else 0):
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        bad = np.where(d2.min(axis=1) < min_sep * min_sep)[0]
        if len(bad) == 0:
            break
        pos[bad, 0] = rng.uniform(BOUNDS[0], BOUNDS[1], len(bad))
        pos[bad, 1] = rng.uniform(BOUNDS[2], BOUNDS[3], len(bad))
        pos = pos.astype(np.float32)
    else:
        if min_sep:  # pragma: no cover
            raise AssertionError("min-separation sampling did not converge")
    vel = rng.uniform(-vmax, vmax, (n, 2)).astype(np.float32)
    return pos, vel


def test_native_step_matches_jax_grid_step(rng):
    """Native C++ engine vs the JAX grid step AND the float64 numpy oracle.

    Regression context: this test used to flake (two stable outcomes ~0.35
    apart) because native_sph_step stepped its input arrays IN PLACE while
    jnp.asarray had zero-copy aliased the same numpy buffers on the CPU
    backend — the async jitted grid_step raced the C++ mutation.  The engine
    now copies its inputs; the input-mutation assert below pins that."""
    import sys

    import jax

    from rust_particle_system.ops.grid import GridSpec
    from rust_particle_system.ops.grid_step import grid_step

    sys.path.insert(0, "tests")
    import numpy_oracle as oracle

    n = 400
    pos, vel = _random_state(rng, n)
    pos0, vel0 = pos.copy(), vel.copy()
    params = make_params(bounds=BOUNDS, gravity=120.0, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=64)

    got_pos, got_vel, got_color = native_sph_step(pos, vel, params)
    np.testing.assert_array_equal(pos, pos0)  # engine must not mutate inputs
    np.testing.assert_array_equal(vel, vel0)

    want = grid_step(make_state(pos, vel), params, spec)
    np.testing.assert_allclose(got_pos, np.asarray(want.pos), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got_vel, np.asarray(want.vel), rtol=1e-4, atol=5e-2)
    np.testing.assert_allclose(got_color, np.asarray(want.color), rtol=1e-3,
                               atol=2e-3)

    op = oracle.Params(bounds=BOUNDS, gravity=120.0, shader_delay=0)
    want_pos, want_vel, _ = oracle.step(pos, vel, op, frame=0)
    np.testing.assert_allclose(got_pos, want_pos, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got_vel, want_vel, rtol=1e-4, atol=0.5)


def test_native_step_large_n_runs(rng):
    n = 20_000
    pos, vel = _random_state(rng, n)
    params = make_params(bounds=BOUNDS, gravity=100.0, shader_delay=0)
    got_pos, got_vel, _ = native_sph_step(pos, vel, params)
    assert np.all(np.isfinite(got_pos)) and np.all(np.isfinite(got_vel))
    assert got_pos[:, 0].min() >= BOUNDS[0] and got_pos[:, 0].max() <= BOUNDS[1]


def test_native_io_roundtrip(tmp_path, rng):
    n = 1000
    pos, vel = _random_state(rng, n)
    color = rng.random((n, 4)).astype(np.float32)
    path = str(tmp_path / "state.sph")
    native_state_save(path, pos, vel, color)
    p2, v2, c2 = native_state_load(path)
    np.testing.assert_array_equal(pos, p2)
    np.testing.assert_array_equal(vel, v2)
    np.testing.assert_array_equal(color, c2)


def test_native_io_detects_corruption(tmp_path, rng):
    n = 64
    pos, vel = _random_state(rng, n)
    color = np.ones((n, 4), np.float32)
    path = str(tmp_path / "state.sph")
    native_state_save(path, pos, vel, color)
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0xFF  # flip a payload byte
    open(path, "wb").write(bytes(raw))
    with pytest.raises(RuntimeError, match="-3"):
        native_state_load(path)
