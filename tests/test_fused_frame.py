"""Tests for the one-frame step+render path of the SPH model (run walk in interpret
mode, then the splat)."""

import jax
import jax.numpy as jnp
import numpy as np

from rust_particle_system.core.params import make_params
from rust_particle_system.core.state import make_state
from rust_particle_system.models import SPHFluid
from rust_particle_system.render import RenderSpec, splat

BOUNDS = (-96.0, 96.0, -54.0, 54.0)
RSPEC = RenderSpec(width=192, height=108, max_radius_px=4)


def _model():
    return SPHFluid.create(bounds=BOUNDS, backend="pallas", render_spec=RSPEC,
                           interpret=True)


def _random_state(rng, n, vmax=15.0):
    pos = np.stack(
        [rng.uniform(BOUNDS[0], BOUNDS[1], n), rng.uniform(BOUNDS[2], BOUNDS[3], n)],
        axis=-1,
    ).astype(np.float32)
    vel = rng.uniform(-vmax, vmax, (n, 2)).astype(np.float32)
    return pos, vel


def test_fused_frame_state_matches_plain_step(rng):
    n = 300
    pos, vel = _random_state(rng, n)
    params = make_params(bounds=BOUNDS, gravity=120.0, shader_delay=0)
    model = _model()

    state = make_state(pos, vel)
    want = model.step(state, params)
    got, img = jax.jit(model.step_and_render)(state, params)
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(want.pos), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.vel), np.asarray(want.vel), rtol=1e-5, atol=1e-4)
    assert int(got.frame) == int(want.frame)
    assert img.shape == (108, 192, 4)


def test_fused_frame_image_matches_standalone_splat(rng):
    """The fused image must equal rasterizing the END state with the reference splat."""
    n = 300
    pos, vel = _random_state(rng, n)
    params = make_params(bounds=BOUNDS, gravity=120.0, shader_delay=0)

    state = make_state(pos, vel)
    new_state, img = _model().step_and_render(state, params)
    want = np.asarray(
        splat(new_state.pos, new_state.color, params.particle_size,
              jnp.asarray(BOUNDS, jnp.float32), RSPEC)
    )
    np.testing.assert_allclose(np.asarray(img), want, rtol=1e-3, atol=1e-3)


def test_fused_frame_warmup_freezes_state_and_renders(rng):
    n = 64
    pos, vel = _random_state(rng, n)
    params = make_params(bounds=BOUNDS, gravity=400.0, shader_delay=3)
    frame = jax.jit(_model().step_and_render)
    s = make_state(pos, vel)
    for _ in range(3):
        s, img = frame(s, params)
    np.testing.assert_array_equal(np.asarray(s.pos), pos)
    assert int(s.frame) == 3
    # the warm-up image shows the frozen (white) particles
    assert np.asarray(img)[..., :3].max() > 0.1


def test_update_params_rejects_radius_above_cell_size():
    import pytest

    from rust_particle_system.models import SPHFluid
    from rust_particle_system.runtime import Simulation

    model = SPHFluid.create(n=64, bounds=BOUNDS, capacity=16, backend="grid")
    sim = Simulation(model, n=64)
    with pytest.raises(ValueError, match="exceeds the grid cell size"):
        sim.update_params(smoothing_radius=12.0)
    sim.update_params(smoothing_radius=6.0)  # lowering is free
