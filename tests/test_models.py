"""Tests for the attractor / flow-field / N-body model families and the SPH model."""

import jax
import jax.numpy as jnp
import numpy as np

from rust_particle_system.models import (
    Attractor,
    FlowField,
    NBody,
    SPHFluid,
    make_attractor_params,
    make_nbody_params,
    nbody_accel,
)
from rust_particle_system.models.flow_field import curl_velocity, make_flow_params


def _in_bounds(pos, bounds):
    x_min, x_max, y_min, y_max = bounds
    return (
        np.all(pos[:, 0] >= x_min)
        and np.all(pos[:, 0] <= x_max)
        and np.all(pos[:, 1] >= y_min)
        and np.all(pos[:, 1] <= y_max)
    )


def test_attractor_pulls_particles_toward_point():
    model = Attractor.create(bounds=(-100.0, 100.0, -100.0, 100.0))
    params = make_attractor_params(
        bounds=model.bounds, gravity=0.0, attractor_pos=(50.0, 0.0),
        attractor_strength=1000.0,
    )
    state = model.init(jax.random.key(0), 64)
    d0 = np.linalg.norm(np.asarray(state.pos) - [50.0, 0.0], axis=1).mean()
    for _ in range(20):
        state = jax.jit(model.step)(state, params)
    d1 = np.linalg.norm(np.asarray(state.pos) - [50.0, 0.0], axis=1).mean()
    assert d1 < d0
    assert _in_bounds(np.asarray(state.pos), model.bounds)


def test_attractor_position_change_no_recompile():
    model = Attractor.create()
    params = model.default_params()
    state = model.init(jax.random.key(0), 32)
    step = jax.jit(model.step)
    state = step(state, params)
    state = step(state, params._replace(attractor_pos=jnp.asarray([100.0, 100.0])))
    assert step._cache_size() == 1


def test_flow_field_is_divergence_free():
    """curl(ψ) must have zero divergence — finite-difference check."""
    params = make_flow_params(seed=3)
    pts = jax.random.uniform(jax.random.key(1), (64, 2), minval=-500, maxval=500)
    eps = 0.05
    ex = jnp.asarray([eps, 0.0])
    ey = jnp.asarray([0.0, eps])
    dvx = (curl_velocity(pts + ex, 0.7, params)[:, 0] -
           curl_velocity(pts - ex, 0.7, params)[:, 0]) / (2 * eps)
    dvy = (curl_velocity(pts + ey, 0.7, params)[:, 1] -
           curl_velocity(pts - ey, 0.7, params)[:, 1]) / (2 * eps)
    div = np.asarray(dvx + dvy)
    scale = float(jnp.abs(curl_velocity(pts, 0.7, params)).mean())
    assert np.abs(div).max() < 1e-2 * max(scale, 1.0)


def test_flow_field_advects_and_wraps():
    model = FlowField.create(bounds=(-100.0, 100.0, -50.0, 50.0))
    params = model.default_params()
    state = model.init(jax.random.key(0), 256)
    p0 = np.asarray(state.pos).copy()
    for _ in range(50):
        state = jax.jit(model.step)(state, params)
    pos = np.asarray(state.pos)
    assert _in_bounds(pos, model.bounds)  # wrapped, never escapes
    assert np.abs(pos - p0).mean() > 1.0  # actually moved
    assert np.all(np.isfinite(np.asarray(state.vel)))


def test_nbody_accel_symmetry_and_softening():
    params = make_nbody_params(softening=5.0, repulsion=0.0)
    pos = jnp.asarray([[-10.0, 0.0], [10.0, 0.0]], jnp.float32)
    acc = np.asarray(nbody_accel(pos, params))
    # pure attraction: accelerations point at each other, equal magnitude
    assert acc[0, 0] > 0 and acc[1, 0] < 0
    np.testing.assert_allclose(acc[0], -acc[1], rtol=1e-5)
    # coincident particles stay finite thanks to softening
    acc2 = np.asarray(nbody_accel(jnp.zeros((2, 2)), params))
    assert np.all(np.isfinite(acc2))


def test_nbody_cluster_formation_bounded():
    model = NBody.create(bounds=(-200.0, 200.0, -200.0, 200.0))
    params = make_nbody_params(bounds=model.bounds)
    state = model.init(jax.random.key(2), 256)
    for _ in range(30):
        state = jax.jit(model.step)(state, params)
    pos = np.asarray(state.pos)
    assert np.all(np.isfinite(pos))
    assert _in_bounds(pos, model.bounds)


def test_sph_model_end_to_end_with_render():
    model = SPHFluid.create(
        n=256, bounds=(-96.0, 96.0, -54.0, 54.0), capacity=32,
        render_spec=__import__(
            "rust_particle_system.render", fromlist=["RenderSpec"]
        ).RenderSpec(width=192, height=108, max_radius_px=4),
    )
    params = model.default_params()._replace(
        shader_delay=jnp.asarray(0, jnp.int32), gravity=jnp.asarray(200.0, jnp.float32)
    )
    state = model.init(jax.random.key(0), 256)
    for _ in range(5):
        state = model.step(state, params)
    img = np.asarray(model.render(state, params))
    assert img.shape == (108, 192, 4)
    assert img[..., :3].max() > 0.1  # particles visible
    assert np.all(np.isfinite(img))
