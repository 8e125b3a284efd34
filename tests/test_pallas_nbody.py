"""Parity tests: the Pallas-Triton N-body kernel (interpret mode) vs the jnp version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rust_particle_system.models import make_nbody_params, nbody_accel
from rust_particle_system.ops.pallas.nbody import (
    BLOCK_I,
    BLOCK_J,
    TARGET_PROGRAMS,
    j_splits,
    nbody_accel_pallas,
)


@pytest.mark.parametrize("n", [256, 1024, 1000])  # 1000: exercises the masks
def test_pallas_accel_matches_jnp(rng, n):
    pos = jnp.asarray(rng.uniform(-500, 500, (n, 2)), jnp.float32)
    params = make_nbody_params()
    want = np.asarray(nbody_accel(pos, params))
    got = np.asarray(nbody_accel_pallas(pos, params, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("splits", [1, 2, 3, 16])
def test_pallas_accel_split_partner_ranges_agree(rng, splits):
    """Any split of the partner range (even one leaving a split empty) sums to
    the same accelerations."""
    pos = jnp.asarray(rng.uniform(-500, 500, (3 * BLOCK_J + 7, 2)), jnp.float32)
    params = make_nbody_params()
    want = np.asarray(nbody_accel(pos, params))
    got = np.asarray(nbody_accel_pallas(pos, params, interpret=True, splits=splits))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("n", [1, BLOCK_I, 16_384, 1_000_000])
def test_j_splits_fills_the_card_without_empty_work(n):
    s = j_splits(n)
    assert 1 <= s <= -(-n // BLOCK_J)
    if n >= BLOCK_J * TARGET_PROGRAMS:
        assert s == 1  # enough i-blocks already
    else:
        assert -(-n // BLOCK_I) * s >= min(TARGET_PROGRAMS, -(-n // BLOCK_I) * -(-n // BLOCK_J))


def test_pallas_accel_coincident_particles_finite(rng):
    pos = jnp.zeros((256, 2), jnp.float32)
    params = make_nbody_params()
    got = np.asarray(nbody_accel_pallas(pos, params, interpret=True))
    assert np.all(np.isfinite(got))


def test_nbody_model_pallas_backend_step(rng):
    from rust_particle_system.models import NBody

    model = NBody.create(backend="pallas", interpret=True)
    params = make_nbody_params(bounds=model.bounds)
    state = model.init(jax.random.key(0), 512)
    out = jax.jit(model.step)(state, params)
    ref = jax.jit(NBody.create(backend="jnp").step)(state, params)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel), rtol=1e-4, atol=2e-3)
