"""Golden-trajectory tests: JAX O(n²) reference step vs. the independent NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from rust_particle_system.core.params import make_params
from rust_particle_system.core.state import make_state, scatter_init
from rust_particle_system.ops.reference_step import reference_step

import numpy_oracle as oracle


def _random_state(rng, n, bounds=(-100.0, 100.0, -50.0, 50.0), vmax=30.0):
    x_min, x_max, y_min, y_max = bounds
    pos = np.stack(
        [rng.uniform(x_min, x_max, n), rng.uniform(y_min, y_max, n)], axis=-1
    )
    vel = rng.uniform(-vmax, vmax, (n, 2))
    return pos, vel


def test_single_step_matches_numpy_oracle(rng):
    n = 64
    bounds = (-100.0, 100.0, -50.0, 50.0)
    pos, vel = _random_state(rng, n, bounds)
    params = make_params(bounds=bounds, gravity=50.0, shader_delay=0)
    op = oracle.Params(bounds=bounds, gravity=50.0, shader_delay=0)

    state = make_state(pos, vel, frame=0)
    out = jax.jit(reference_step)(state, params)

    want_pos, want_vel, want_color = oracle.step(pos, vel, op, frame=0)
    np.testing.assert_allclose(np.asarray(out.pos), want_pos, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.vel), want_vel, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(out.color), want_color, rtol=1e-3, atol=1e-3)
    assert int(out.frame) == 1


def test_multi_step_trajectory_matches_oracle(rng):
    n = 32
    bounds = (-60.0, 60.0, -40.0, 40.0)
    pos, vel = _random_state(rng, n, bounds, vmax=10.0)
    params = make_params(bounds=bounds, gravity=100.0, shader_delay=0)
    op = oracle.Params(bounds=bounds, gravity=100.0, shader_delay=0)

    state = make_state(pos, vel)
    step = jax.jit(reference_step)
    np_pos, np_vel = pos, vel
    for frame in range(5):
        state = step(state, params)
        np_pos, np_vel, _ = oracle.step(np_pos, np_vel, op, frame=frame)
    np.testing.assert_allclose(np.asarray(state.pos), np_pos, rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(state.vel), np_vel, rtol=1e-3, atol=5e-2)


def test_warmup_delay_is_identity():
    params = make_params(shader_delay=5, gravity=500.0)
    state = scatter_init(jax.random.key(0), 128, params.bounds)
    step = jax.jit(reference_step)
    s = state
    for _ in range(5):
        s = step(s, params)
    np.testing.assert_array_equal(np.asarray(s.pos), np.asarray(state.pos))
    np.testing.assert_array_equal(np.asarray(s.vel), np.asarray(state.vel))
    assert int(s.frame) == 5
    # frame 5 onwards the physics runs
    s2 = step(s, params)
    assert not np.allclose(np.asarray(s2.vel), np.asarray(s.vel))


def test_step_is_deterministic(rng):
    n = 48
    pos, vel = _random_state(rng, n)
    params = make_params(bounds=(-100.0, 100.0, -50.0, 50.0), shader_delay=0)
    state = make_state(pos, vel)
    a = jax.jit(reference_step)(state, params)
    b = jax.jit(reference_step)(state, params)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
    np.testing.assert_array_equal(np.asarray(a.vel), np.asarray(b.vel))


def test_particles_stay_in_bounds_many_steps():
    bounds = (-50.0, 50.0, -30.0, 30.0)
    params = make_params(bounds=bounds, gravity=300.0, shader_delay=0)
    state = scatter_init(jax.random.key(1), 256, bounds)
    step = jax.jit(reference_step)
    for _ in range(20):
        state = step(state, params)
    pos = np.asarray(state.pos)
    assert np.all(pos[:, 0] >= bounds[0]) and np.all(pos[:, 0] <= bounds[1])
    assert np.all(pos[:, 1] >= bounds[2]) and np.all(pos[:, 1] <= bounds[3])
    assert np.all(np.isfinite(np.asarray(state.vel)))


def test_coincident_particles_get_separated_not_nan():
    # two particles at identical positions exercise the (0,1) direction fallback
    pos = np.zeros((2, 2), dtype=np.float32)
    vel = np.zeros((2, 2), dtype=np.float32)
    params = make_params(bounds=(-100.0, 100.0, -50.0, 50.0), shader_delay=0)
    state = make_state(pos, vel)
    out = jax.jit(reference_step)(state, params)
    assert np.all(np.isfinite(np.asarray(out.vel)))
    assert np.all(np.isfinite(np.asarray(out.pos)))


def test_scatter_init_matches_reference_layout():
    bounds = (-960.0, 960.0, -540.0, 540.0)
    n = 1000
    st = scatter_init(jax.random.key(0), n, bounds)
    pos = np.asarray(st.pos)
    # x uniform sweep across width (src/main.rs:200-201)
    np.testing.assert_allclose(pos[0, 0], -960.0, atol=1e-3)
    np.testing.assert_allclose(
        pos[:, 0], -960.0 + np.arange(n) / n * 1920.0, atol=1e-2
    )
    # y roughly Normal(0, 135) clamped
    assert abs(pos[:, 1].mean()) < 20.0
    assert 100.0 < pos[:, 1].std() < 170.0
    assert np.all(pos[:, 1] >= -540.0) and np.all(pos[:, 1] <= 540.0)
    np.testing.assert_array_equal(np.asarray(st.vel), 0.0)
    np.testing.assert_array_equal(np.asarray(st.color), 1.0)
